#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py            # full size, one NVIDIA H100
    python3 chip_smoke.py --quick    # small matrix, olmoe-smoke: every check

Run from the repository root on a machine with a CUDA card; it imports the
port from ``src/`` and nothing of JAX or of the JAX package. It drives the
port's main path — ``compile_spmm(a, 8, SpmmConfig(backends=("coo",
"bsr")))``, then ``h(b)``, ``h(b, backend="bsr")`` and ``h(b)`` again —
at the scale of ogbn-arxiv (169,343 nodes rounded up to 169,344 = 8 ×
21,168 so that 8 | M, 1,166,243 edges, 128 feature columns), on a uniform
matrix (coo and bsr) and a power-law one (coo: its ELL form would need
~86 GB), then GAT inference on the uniform graph through the FusedMM
handle. Phases, each of which raises on a failed check:

1. build: nvcc builds K1–K6 and K6's backward from
   ``src/repro_torch/csrc``;
2. kernels: every kernel's calls on each path are recorded and replayed
   against the kernel's plain torch version on the same inputs (K1 in
   both forms — the pack and the scaled coo gather — K2, K5 and K6 bit
   for bit, float32 1e-5 for K3/K4), and again at
   ``tests/test_kernels.py``'s sweeps (bfloat16 6e-2), for K5 on
   sparse blocks at the GAT pieces' shapes, and for K6 at the LM's
   shapes and each of its kernels' layouts (y and r bit for bit, both
   chains, the backward with r formed == with r saved); each is timed
   beside its bound, its plain version and one PyTorch library call for
   the same function (for K1's scaled form, ``index_select`` then
   ``mul``, and the former K1 pack + multiply pair beside it), and its
   wrapper's host time per launch is taken over 200 back-to-back calls;
3. main path, uniform: C within 2e-4 of scipy in float64, the model's
   decisions, collective rows == ``volume_rows_padded``, staged C
   bit-identical to overlapped (bsr and coo), two ``h(b)`` calls
   bit-identical, every kernel launched;
4. main path, power-law (coo): the same checks, and its K1/K2 calls
   replayed against their plain versions as in phase 2;
5. GAT: ``compile_fused(normalize_adjacency(a), 8, SpmmConfig(kernel=
   "fused", edge="leaky_relu", backends=("coo", "bsr")))`` serves a
   2-layer GAT (ogbn-arxiv's 128 features and 40 classes, 128 hidden,
   att_dim 16, weights from numpy seed 0 through ``gat_from_numpy``), one
   forward per backend, then ``h(x, y, kernel="sddmm")`` at F = 128 on
   bsr: decisions equal the reference's, each layer's C and the output
   within 2e-4 of scipy float64, the sampled values within 2e-4 of float64,
   the fused log's shift pairs equal the spmm call's, coo and bsr agree
   and repeat bit for bit, K1, K2, K3 and K5 launched on bsr and K1 (both
   forms), K2 on coo; the kernel calls of both forwards and of the F = 128 SDDMM
   are replayed against the plain versions as in phase 2;
5b. hier: the same three cells with ``hier="auto"`` — ``compile_spmm``
   on the uniform matrix (coo and bsr: K1-K4) and the power-law one (coo:
   K1, K2), ``compile_fused`` on the GAT graph (a 2-layer GAT forward per
   backend, then the F = 128 SDDMM on bsr: K1, K2, K3, K5), each on the
   (G, L) = (2, 4) grid of the 8 ranks. Decisions equal the reference's
   (``EXPECT_HIER``), C / each layer's C / the output / the sampled values
   within 2e-4 of scipy float64, the group-axis rows of the log ==
   ``volume_rows_padded`` (local-axis rows and the slow-tier rows against
   the flat plan's logged), staged == overlapped and call == call bit for
   bit, coo vs bsr within 2e-4, every kernel of the cell launched, the
   fused log's group pairs equal the spmm call's; each kernel's hier
   calls are replayed against its plain version as in phase 2 (paths
   ``hier_*`` in the kernels line);
5c. replicated: the two SpMM cells with ``replicate="auto"`` —
   ``compile_spmm`` on the uniform matrix (coo and bsr: K1 in both forms,
   K2, K3) and the power-law one (coo: K1, K2), each on c = 2 lanes of
   s = 4 shards. Decisions equal the reference's (``EXPECT_REPL``: c, s,
   the lane shifts, the rounds, R_b, R_c, ``volume_rows_padded``, the
   modeled times), C within 2e-4 of scipy float64, the lane-axis rows of
   the log == ``volume_rows_padded`` (the replica reduce-scatter's rows
   and B's c-fold copy logged apart), call == call bit for bit, coo vs
   bsr within 2e-4, every kernel of the cell launched; each kernel's
   replicated calls are replayed against its plain version as in phase 2
   (paths ``repl_*`` in the kernels line);
5d. training, through the backward compositions (``kernels.ops``):
   ``dB`` of ½‖h(b)‖² through every coo SpMM handle of phases 3-5c against
   Aᵀ(A b) by scipy in float64 (2e-4), the backward's collective rows ==
   the forward's on each axis, a bsr call under grad refused; the GAT
   handle's bsr SDDMM under grad (K5's Function, K3 in the backward)
   against float64 (rtol 2e-3 / atol 2e-4); then two training cells with
   AdamW (lr 5e-3, warmup 10, no decay): gcn-train-arxiv, a GCN 128 → 256
   → 256 → 40 (OGB's ogbn-arxiv GCN widths) on ``compile_spmm(
   normalize_adjacency(power-law), 8)`` for 200 epochs, and
   gat-train-arxiv, the GAT of phase 5 on the fused handle's coo backend
   for 50 (weights from numpy seed 0, features seed 1, labels seed 2).
   Each cell's first step runs counted (launches by kernel and direction)
   under an op watch that fails on ``index_add`` / ``scatter_add`` /
   sparse products / accumulating ``index_put`` or a plain version on the
   card, then again with every kernel call checked and timed against its
   plain version as it happens (paths ``gcn_step``, ``gat_step``,
   ``gat_sddmm_grad``): the two give the same grads, every grad within
   rtol 2e-3 / atol 2e-4 of a float64 oracle, the backward's rows == the
   forward's per call and axis; the loss falls, and ten steps repeat bit
   for bit from a fresh start. Per-epoch times (CUDA events: forward,
   backward, update; host wall), the prep ratio and peak memory printed;
6. timing: median ``h(b)`` per backend and median GAT forward per backend,
   each hier and replicated cell beside the flat one on the same matrix
   (``--profile`` also names the device time of each kind of collective:
   the reduce-scatters' additions, the all_gather's copies, the rolls,
   the lane exchanges and B's c-fold copy);
7. LM serving: OLMoE-1B-7B at its published width (bfloat16, 16 layers,
   d_model 2048, 64 experts top-8, vocab 50304; random weights from
   ``torch.Generator("cuda").manual_seed(0)``; ``--quick``: olmoe-smoke)
   through the port's transformer: a prefill ``forward`` of 8 prompts ×
   128 tokens, then ``ContinuousBatcher(max_batch=8, max_len=128)``
   serving 12 requests (prompts of 8–16 tokens, 16 new tokens each: two
   waves), twice, with identical outputs; every RMSNorm is K6 (2·16 + 1
   launches per forward and per decode step), and the K6 calls of one
   prefill and one decode step are replayed against the plain version
   (float32 1e-5, bfloat16 one ulp); a float32 copy of the first 2 layers
   gives ``decode_step`` logits equal to ``forward``'s within 2e-4, both
   within 2e-4 of a float64 run of the plain versions; then the SHIRO
   dispatch of one 8 × 128 prefill, ``compile_dispatch(cfg, tokens=1024,
   M=8)``, with decisions equal to the reference's, ``h(x)`` on x [1024,
   2048] float32 within 2e-4 of the dense dispatch and its K1/K2 calls
   replayed exactly;
8. lifecycle, on the two SpMM matrices, with an autotune cache in a
   directory of ``build/`` that the phase makes and removes:
   ``compile_spmm(uniform, 8, backends=("coo", "bsr"), hier="auto",
   measure=True)`` and ``compile_spmm(power-law, 8, hier="auto",
   measure=True)`` — on a quarter of the two matrices (``LIFE_SCALE``:
   the same generators and seeds at 42,336 nodes, as the whole phase
   since it was cut to keep the script in its limit) — time the model's
   top 3 candidates on the card (every
   candidate printed with its model and measured ms, the winner beside
   the model-only decision; no candidate may be skipped), C within 2e-4
   of scipy float64 and the logged rows == ``volume_rows_padded``; the
   same two compiles again replay the cache (zero profile hooks, the
   same decisions, C bit for bit); on uniform coo with a host B the
   first call's ``total_allocation_size`` is strictly lower with
   ``donate=True`` than without, C bit-identical, a caller's CUDA B
   untouched; ``SpmmSession.build(power-law, 8, hier="auto",
   p_ladder=(4, 8))`` runs 2 MWVC builds, each rung's decisions equal
   the reference's (``EXPECT_SERVE_LADDER``, phase 9's) and C is
   within 2e-4, and
   ``on_resize(4)`` / ``on_resize(8)`` build nothing; a values-only
   change refreshes in place (drift 0.0, no new memo entry, C == a cold
   compile's bit for bit); 15% of the edges rewired hot-swaps to a
   warmed handle (one MWVC build, the first call a memo hit); the bundle
   round-trips bit for bit and a torn one fails naming the file;
   ``nan_poison`` at the output raises ``NumericalFault``, a torn
   autotune entry warns, re-profiles and is rewritten, and with no plan
   ``check=False`` C == ``check="auto"`` C. The K1–K4 calls of one call
   of each winner (the uniform one on both backends) and of the
   refreshed handle are replayed against the plain versions (path
   ``lifecycle`` in the kernels line). Donation is measured on four
   cases: the uniform cell and ``tests/test_torch_cuda.py``'s
   ``DONATION_CASES`` (the reference's own power-law pin among them),
   each strictly lower donated, with where each first call's peak falls
   (the allocator's history);
9. serving, on a quarter of arxiv (phase 8's matrices,
   ``LIFE_SCALE``, to keep the script inside its limit): an
   ``SpmmWaveServer`` (max_batch 2, host B) over ``SpmmSession.build(
   power-law, 8, hier="auto", p_ladder=(4, 8))`` attached to an
   ``ElasticController`` serves census 8 -> 5 -> 8 (no MWVC build, rungs
   ``EXPECT_SERVE_LADDER``, from ``scripts/reference_phase9_pins.py``),
   a 15% rewire
   (hot swap) and two injected ``wave_error`` faults (retried, degraded
   to rung 4: failed 2, retried 1, degraded 1, dropped 0), every
   request's C == a cold compile's on its (P, pattern), then 16 timed
   requests; ``SpmmFleet(Topology.local(8), group_sizes=(4, 4))`` admits
   power-law, a second power-law graph of its size and a 16,384-node one
   in both orders (placements and scores == ``EXPECT_FLEET``), serves,
   rebalances with one migration and no MWVC build, takes a drift replan
   and rolls back an injected ``fleet_migrate_fail``, every C == a cold
   compile's at P=4; the uniform matrix on the bsr backend migrates
   between groups of 2 and 4 ranks (moved rows == the reference's, the
   resharded slabs reassemble to the served B and C, C at both P == a
   cold compile's). The K1–K4 calls of one call of each fleet tenant are
   replayed against the plain versions (path ``fleet``);
10. expert-parallel LM, run right after phase 7 on its weights:
   OLMoE-1B-7B (``capacity_factor`` 1.25 as published, ``--quick``:
   olmoe-smoke) through ``_moe_ep`` with SHIRO's dedup on an emulated
   (data 2, model 4) grid (``make_context(make_mesh((2, 4), ("data",
   "model")))``): a prefill of 8 × 128 tokens (the dropped assignments
   per layer printed; the log's activation rows == 2 exchanges ×
   Dsz·M·M·cap a layer; K1 2·16, K2 2·16, K6 33 launches per forward
   and per decode step) and ``ContinuousBatcher(..., dist=)``
   serving phase 7's 12 requests twice with identical tokens; on a
   float32 copy of the first 2 layers: EP == dense and shiro == classic
   within 2e-4 at capacity 8.0 (no drops; the dedup fills fewer dispatch
   rows), ``decode_step`` == ``forward`` and ``kv_seq_shard`` decode ==
   unsharded decode within 2e-4, the model ranks' outputs and a repeat
   bit-identical, and at capacity 1.25 the card == the port's CPU run
   within 2e-4 with equal drops; then ``dispatch_session(cfg, 1024, 8)``
   with decisions ``EXPECT_DISPATCH``, ``maybe_replan`` of a seed-1
   routing == the reference's (``EXPECT_SESSION_REPLAN``, then
   ``EXPECT_SESSION_DRIFTED``) and C within 2e-4 of the dense dispatch
   before and after. Prefill, decode-step (CUDA events, host wall) and
   batcher tokens/s beside the dense path's. Every K1 / K2 / K6 call of
   one prefill and one decode step is checked against its plain version
   as it runs (paths ``ep_prefill``, ``ep_decode``), and the session
   handle's K1 / K2 calls are replayed (path ``dispatch_session``).
11. SHIRO across two processes on the card, after phase 9: (a) the
   launcher's smoke (``python -m repro_torch.launch.multiprocess --nproc
   2 --local-devices 4``, every worker on ``cuda:0``); (b) two workers
   (this script with ``--mp-worker DIR``, started by ``launch_local``)
   of 4 ranks each compile mp-powerlaw-arxiv flat (coo), mp-powerlaw-arxiv
   hier (``hier="auto"`` → the fleet's (2, 4)) and mp-uniform-arxiv hier
   (bsr, overlapped: K3 / K4) on ``Topology.multiprocess()``, on a
   quarter of arxiv (``LIFE_SCALE``; pins from
   ``scripts/reference_fleet_pins.py``), decisions == ``EXPECT_MP``;
   each process's C rows ``torch.equal`` to the same
   rows of a ``Topology.local(8)`` run of the same plan and within 2e-4
   of scipy float64, rows per axis summed over the processes == the
   emulated log's (== ``volume_rows_padded`` on the plan's axis), rows
   across processes == ``plan_crossing_rows()``; h(b) median of 7 by
   CUDA events and host wall beside its staging and gloo seconds; each
   worker's K1–K4 calls of one h(b) replayed against the plain versions,
   one process at a time (paths ``mp_flat``, ``mp_hier``,
   ``mp_uniform_hier``). The same workers then run the MoE dispatch and
   the rungs below the fleet: olmoe-1b-7b's ``compile_dispatch(cfg, 1024,
   8, where=topo)`` at its published width (float32 x) and
   ``dispatch_session`` through ``maybe_replan``'s three branches
   (``EXPECT_MP_DISPATCH``; paths ``mp_dispatch``,
   ``mp_dispatch_session``); a session with rungs (4, 6, 8) on each of
   the power-law and uniform matrices, served at rung 8,
   ``on_resize(6)`` (spans [(0, 4), (4, 6)]), ``on_resize(4)`` (worker 1
   holds no rank, returns [0, 128], launches nothing and joins every
   exchange), the group [2, 6) carved across the boundary and the whole
   fleet again, no MWVC run on a resize (``EXPECT_MP_RUNG``; paths
   ``mp_rung_power_law``, ``mp_rung_uniform``: the calls of one h(b) at
   each of rungs 6 and 4 and on the group); and a
   ``SpmmWaveServer`` wave failed twice on both workers, which degrade
   8 -> 6 (``mp_degrade``). Every such call: C rows == the emulated
   run's and within 2e-4 of float64, rows per axis and across
   processes as the plan counts, median of 7 with staging and gloo
   shares. (c) ``--supervise`` drills: a ``worker_kill``
   at ``stage:serve`` of rank 1 in epoch 0 recovers after one restart,
   and kills in every epoch with ``--max-restarts 0`` degrade to one
   process that serves rung 4; (a) and (c) run side by side before (b).
   Every wait has a deadline (``MP_TIMEOUT``).
12. training and the expert-parallel LM across the two processes, after
   phase 11: two workers (this script with ``--mp-train-worker DIR``,
   phase 11's ``launch_local``) of 4 ranks each on ``cuda:0``.
   mp-gcn-train-arxiv (phase 5d's GCN, weights, features, labels and
   AdamW on ``normalize_adjacency(power-law)``) flat and with
   ``hier="auto"``, and mp-gat-train-arxiv (phase 5's GAT on the fused
   handle, coo) on ``Topology.multiprocess()``, on a quarter of arxiv
   (``LIFE_SCALE``, as phases 8, 9 and 11; the decisions re-derived by
   ``scripts/reference_fleet_pins.py``): decisions ==
   ``EXPECT_MP_TRAIN``; dB of ½‖h‖² on each process == the rows of a
   ``Topology.local(8)`` run of the same plan bit for bit, the
   backward's rows per axis == the forward's and its rows across
   processes == the forward's == ``plan_crossing_rows()``; the first
   step under the op watch, its loss and every gradient (summed over the
   processes by ``reduce_grads``) within rtol 2e-3 / atol 2e-4 of the
   emulated run's; 5 (GCN) / 3 (GAT) epochs on the fleet with the
   parameters ``torch.equal`` on both processes after every step, and
   the same epochs on ``Topology.local(8)`` with the losses within that
   tolerance; per-epoch forward / backward / update by CUDA events, host
   wall, gloo and staging. Then mp-olmoe-serve-ep: OLMoE-1B-7B at its
   published width cut to 4 of its 16 layers (``MP_EP_LAYERS``; seed 0;
   each process the dense weights and the
   experts of its 4 model ranks) on a (data 1, model 8) grid over the
   fleet (``Topology.multiprocess(mesh=...)``, the model axis crossing
   the processes): an 8 × 128 prefill, one ``decode_step`` and the
   batcher's 12 requests, the same logits and tokens on both processes,
   the log's activation rows == 2 · Dsz·M·M·cap a layer, the bf16
   tokens beside the emulated (data 1, model 8) run's; on a float32 copy
   of the first 2 layers the fleet == the emulated grid and
   ``_moe_dense`` at capacity 8.0, the seq-shard decode == unsharded
   (2e-4), the model ranks' outputs bit-identical across the processes,
   the drops at 1.25 == the emulated run's. Each worker's K1 / K2 / K6
   calls of one training step and of one prefill / decode step are
   replayed against the plain versions one process at a time (paths
   ``mp_gcn_step``, ``mp_gat_step``, ``mp_ep_prefill``,
   ``mp_ep_decode``). First of all (while the host holds no recorded
   calls), the LM train step on the fleet's grid, ``MP_LM_CASES``:
   OLMoE-1B-7B at its published width cut to 1 layer (dense: its MoE
   swapped for a SwiGLU MLP of d_ff) on (data 2, model 4) and EP at
   capacity 1.25 on (data 2, model 4) and on (data 1, model 8), 3
   ``make_train_step`` steps each on one ``SyntheticLM`` 8 × 128 batch
   (``lm_loss`` this process's share, ``fold_leaves``, AdamW with the
   grid's ``GradShards``), a bit digest of every parameter after each
   step and the last step's parameters saved. The (data 1, model 8) EP
   case (``MP_LM_TRAINER``) runs through ``Trainer.fit`` on the fleet
   (the donating step): checkpoints at steps 2 and 3, each the unsharded
   tree (6.26 GB at this width) written by worker 0 after the experts'
   params and moments are gathered over the model ranks; worker 0 then
   deletes step 3 and a second ``fit`` resumes every process from 2 to
   the uninterrupted run's parameters, ``torch.equal``. One more
   (donating) step split by CUDA events into forward / backward / fold /
   update beside the host wall, gloo and staging seconds, the fold's
   bytes and the activation rows across; peak memory per process; each
   save's wall seconds beside its gather, host copy and write seconds
   (the write's sha256 seconds in it), each restore's sha256 and read
   seconds (the phase's process restores one after the other), and
   the bytes. Worker 0's K1 / K2 / K6 /
   K6-backward calls of one step are replayed (paths
   ``mp_lm_train_dense``, ``mp_lm_train_ep``, ``mp_lm_train_ep_cross``).
   Then (``MP_FAMILY_CASES``, each model released before the next) the
   hybrid, encdec, vlm and audio families at their published widths cut
   in depth — zamba2-2.7b's first group (6 Mamba2 layers and the shared
   block), seamless-m4t-medium's 1 + 1 layers over its 1024 frames,
   llava-next-mistral-7b's 1 layer over 576 patches + 448 tokens, and
   llava's path with the audio frontend — each on (data 1, model 8) and
   (data 2, model 4): ``forward``, one ``decode_step`` (the encdec's with
   the encoder's output) and 2 ``make_train_step`` steps on 8 prompts,
   the last position's logits, bit digests and the parameters kept.
   After the workers exit, the emulated twin runs the same steps on
   ``make_mesh`` of each grid in this process: each step's loss, grad
   norm and every parameter a worker holds within ``MP_LM_TWIN_TOL``
   and reported ``torch.equal`` or not; the dense case's first loss
   within 5e-3 of the unsharded port's; the (data 1, model 8) EP case's
   step-2 checkpoint restored onto one device ``torch.equal`` to the
   twin's params and moments at step 2, and restored onto the emulated
   (1, 8) grid, one more donating step ``torch.equal`` to the twin's step
   3; the families on (data 1, model
   8) ``torch.equal`` to the twin in every result, on (data 2, model 4)
   the logits within ``MP_FAMILY_ROWS_TOL``, the steps' losses, the first
   step's grad norm and the parameters within ``MP_LM_TWIN_TOL``, and the
   first step's folded gradient within ``MP_FAMILY_GRAD_TOL`` of the
   twin's, leaf by leaf (the second step's grad norm is logged).
13. LM training, after phase 12. (a) olmoe-train: OLMoE-1B-7B at its
   published width, cut to 2 of its 16 layers (1.05 B parameters; all
   16 with AdamW's float32 moments would not fit the card), bf16, random
   weights (``torch.Generator("cuda")`` seed 0), one 8 × 128
   ``SyntheticLM`` batch (seed 0): every leaf's first-step gradient
   finite and non-zero through ``_moe_dense`` and through ``_moe_ep`` on
   the (data 2, model 4) grid at capacity 1.25; one step's K1 / K2 / K6
   / K6-backward calls recorded and replayed against the plain versions
   (paths ``train_dense``, ``train_ep``); one step each under the op
   watch (no index_add / scatter_add / accumulating index_put / plain
   version); 5 ``make_train_step`` steps each way on the repeated batch,
   counted from 0, the loss falling, no backward map built on the host,
   then the same 5 again donating (a copy of the weights updated in
   place, ``make_train_step(..., donate=True)``'s update) timed forward /
   backward / update, AdamW's share of the step logged, and equal bit for
   bit to the functional 5; on a float32 copy (2 × 128 tokens) the
   first-step grads
   within rtol 2e-3 / atol 2e-4 of a float64 run (the plain versions),
   the EP grads at capacity 8.0 within 2e-4 of ``_moe_dense``'s and
   ``microbatches=2``'s first moments within the same tolerances of one
   batch's. (b) smollm-train: ``launch/train.py --arch smollm-135m
   --full`` (all 30 layers, remat) at 8 × 256, 30 steps with checkpoints
   at 10, 20 and 30; the step-30 checkpoint deleted, the run resumed
   from 20 to 30 ends ``torch.equal`` to the uninterrupted run (the
   launcher's ``Trainer`` donates); a donating step timed forward /
   backward / update; the watchdog's events and peak
   memory; one more step's K1 / K2 / K6 / K6-backward calls recorded and
   replayed (path ``train_smollm``, 2048 rows of 576). On every train
   path K6 and its backward also give their profiler busy time, each
   kernel of the backward pair by its own name, and the replays hold the
   forward's saved r (y unchanged, r the plain version's) and the
   backward with and without it. Every K6 row with busy time also gives
   ``F.rms_norm``'s on the same calls' inputs, and a K6 row of calls
   under grad the wrapper's host time without r beside the time with it.
14. falcon-mamba-7b serving, last: the SSM family as published (64
   layers, d_model 4096, d_inner 8192, state 16, chunk 128, vocab 65024,
   bf16, 7.27 B parameters; ``--quick``: its smoke config), random
   weights (``torch.Generator("cuda")`` seed 0): an 8 × 256 prefill (two
   scan chunks, h carried), one decode step, the batcher's 12 requests
   (``LM_SERVE``) with 65 K6 launches a step; prefill and decode-step
   times (CUDA events, host wall), tokens/s, peak memory; a float32 copy
   of the first 2 layers: decode == forward and forward == a float64
   run of the plain versions (2e-4). K6's calls of the prefill, the step
   and the batcher's last 8 steps are replayed with profiler busy time
   beside ``F.rms_norm``'s (paths ``ssm_prefill``, ``ssm_step``,
   ``ssm_batcher``).
15. the hybrid, encdec and prefix families, last, each model as
   published in bf16 with random weights (``torch.Generator("cuda")``
   seed 0; ``--quick``: the smoke configs), each freed before the next is
   built: zamba2-2.7b (54 Mamba2 layers, d_model 2560, the one shared
   attention block applied every 6: 9 groups) on an 8 × 256 prefill;
   seamless-m4t-medium (12 + 12 layers, d_model 1024, vocab 256,206) on
   8 × 128 tokens over its published 1024 encoder frames (numpy seed 0;
   the encoder's attention takes ``flash_attention``, non-causal), its
   decode step given the encoder's output (``_encode``); and
   llava-next-mistral-7b (32 layers, d_model 4096, GQA 32 / 8) on 576
   patches + 448 tokens (1024 positions: flash, causal). For each: one
   decode step, the batcher's 12 requests (the encdec's without
   cross-attention, as the reference's batcher runs it), K6's launches
   per step and the flash calls counted, prefill / decode-step times,
   tokens/s, peak memory, a float32 copy (zamba2's first 12 layers, 2 +
   2 for seamless, 2 for llava with its 1024 positions) against a
   float64 run of the plain versions (2e-4), decode == forward (zamba2,
   seamless with ``enc_out``); K6's calls of the prefill, the step and
   the batcher replayed with profiler busy time (paths
   ``{hybrid,encdec,vlm}_{prefill,step,batcher}``). Then zamba2's first
   12 layers at full width in bf16 train 3 ``make_train_step`` steps
   (AdamW lr 3e-4, warmup 1) on an 8 × 128 batch: every leaf's gradient
   non-zero (the shared block's sums its two uses), the loss falling,
   K6's backward 17 launches a step; a float32 copy's first-step grads
   against float64 (2 × 128 tokens), each leaf within 2e-3 of it
   norm-wise (``FAMILY_TRAIN_F32``: float32 itself is ~1e-3 off there),
   the element-wise error over rtol 2e-3 / atol 2e-4 logged; one step's
   K1 / K2 / K6 / K6-backward calls replayed (path ``hybrid_train``).
   The families' frames and patches are placed in the model's dtype, as
   the dry run's stand-ins are.
16. the dry run against the card, last: ``launch/dryrun.py``'s
   accounting of phase 13's olmoe-train (dense) and smollm-train steps
   and phase 15's zamba2, seamless and llava prefills, traced on the
   meta device in this process on a (data 1, model 1) grid at the shape
   each phase ran: argument bytes equal to the bytes of the tensors the
   phase placed on the card (else the phase fails); arguments + temp
   (and + outputs) beside the peak each measured step requested above
   its start, its arguments added — the train steps donate, and their
   (arguments + temp) ÷ peak must lie in [0.95, 1.05]
   (``DRYRUN_TRAIN_HOLD``); the traced flops over the step's
   measured time as TFLOP/s; the roofline's bound (H100 datasheet
   constants) over the measured time. Then ``run_cell`` as the CLI runs
   it for qwen2-1.5b and olmoe-1b-7b × decode_32k on the (16, 16) grid
   (the olmoe cell's expert-parallel exchange traced), records and
   seconds printed; the kernels' launch counts the same after the meta
   traces as before them.

Every phase's seconds are printed as it ends.

It prints the card's name and power limit, then one JSON line of kernel
rows, then ``{"ok": true, "device": {...}}`` as its last line. Without a
CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

P = 8
N_COLS = 128
M_FULL = 169_344  # ogbn-arxiv's 169,343 nodes, rounded up to 8 | M
NNZ_FULL = 1_166_243  # ogbn-arxiv's edges
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores

# the reference's model decisions at full size (same host code, CPU run)
EXPECT_UNIFORM = dict(strategy="flat", plan_strategy="joint", net="tsubame4",
                      schedule_kind="bucketed", schedule_K=2, overlap=True,
                      volume_rows=589422, volume_rows_padded=602920,
                      volume_rows_padded_single=693952, pattern_nnz=1166229)
EXPECT_UNIFORM_EX = dict(max_b=2135, max_c=8708, R_b=14841, R_c=60524)
EXPECT_POWERLAW = dict(strategy="flat", schedule_kind="bucketed",
                       schedule_K=4, overlap=True, volume_rows=260413,
                       volume_rows_padded=827712)
# the reference's fused decisions on normalize_adjacency(uniform) (the JAX
# package's _plan_and_tune on the same matrix, CPU run)
EXPECT_FUSED = dict(kernel="fused", edge="leaky_relu", schedule_kind="bucketed",
                    schedule_K=2, overlap=False,
                    modeled_time_fused=0.006233900800000001,
                    volume_rows=589422, volume_rows_padded=602920,
                    volume_rows_padded_single=693952, pattern_nnz=1335568)
# the reference's hier="auto" decisions on the same three matrices (the JAX
# package's _plan_and_tune, HierPlan and hier_schedule_layout, CPU run);
# "quick" for --quick's 16,384-node matrices
EXPECT_HIER = {
    "full": {
        "uniform": (dict(strategy="hier", G=2, L=4, schedule_kind="bucketed",
                         schedule_K=1, overlap=True,
                         modeled_time_flat=0.0035635042773333337,
                         modeled_time_hier=0.001064553664, volume_rows=589422,
                         volume_rows_padded=204488,
                         volume_rows_padded_single=408976,
                         pattern_nnz=1166229),
                    dict(max_bg=7018, max_cg=18543, R_bg=12562, R_cg=35256)),
        "power_law": (dict(strategy="hier", G=2, L=4,
                           schedule_kind="bucketed", schedule_K=1,
                           overlap=True,
                           modeled_time_flat=0.0030354198400000003,
                           modeled_time_hier=0.00054682528,
                           volume_rows=260413, volume_rows_padded=180992,
                           volume_rows_padded_single=450656,
                           pattern_nnz=1116853),
                      dict(max_bg=10018, max_cg=18148, R_bg=16424,
                           R_cg=34366)),
        "gat": (dict(strategy="hier", G=2, L=4, kernel="fused",
                     edge="leaky_relu", schedule_kind="bucketed",
                     schedule_K=1, overlap=False,
                     modeled_time_flat=0.0035641816533333336,
                     modeled_time_hier=0.0010652310399999999,
                     modeled_time_fused=0.00212395712, volume_rows=589422,
                     volume_rows_padded=204488,
                     volume_rows_padded_single=408976, pattern_nnz=1335568),
                dict(max_bg=7018, max_cg=18543, R_bg=12562, R_cg=35256)),
    },
    "quick": {
        "uniform": (dict(strategy="hier", G=2, L=4, schedule_kind="bucketed",
                         schedule_K=1, overlap=True,
                         modeled_time_flat=0.00041598651022222224,
                         modeled_time_hier=0.000121671488, volume_rows=57748,
                         volume_rows_padded=20136,
                         volume_rows_padded_single=40272, pattern_nnz=114659),
                    dict(max_bg=703, max_cg=1814, R_bg=1256, R_cg=3459)),
        "power_law": (dict(strategy="hier", G=2, L=4,
                           schedule_kind="bucketed", schedule_K=1,
                           overlap=True,
                           modeled_time_flat=0.00037697924977777783,
                           modeled_time_hier=7.4449472e-05,
                           volume_rows=27371, volume_rows_padded=18448,
                           volume_rows_padded_single=46144,
                           pattern_nnz=107248),
                      dict(max_bg=1050, max_cg=1834, R_bg=1727, R_cg=3463)),
        "gat": (dict(strategy="hier", G=2, L=4, kernel="fused",
                     edge="leaky_relu", schedule_kind="bucketed",
                     schedule_K=1, overlap=False,
                     modeled_time_flat=0.00041605204622222226,
                     modeled_time_hier=0.000121737024,
                     modeled_time_fused=0.00023619264, volume_rows=57748,
                     volume_rows_padded=20136,
                     volume_rows_padded_single=40272, pattern_nnz=131035),
                dict(max_bg=703, max_cg=1814, R_bg=1256, R_cg=3459)),
    },
}
# the reference's replicate="auto" decisions on the two SpMM matrices (the
# JAX package's _plan_and_tune and build_replicated_schedule, CPU run):
# (stats(), the exec plan's sizes, the schedule's lane shifts and rounds
# as (shifts, slot_b, slot_c, off_b, off_c, b_lanes, c_lanes))
EXPECT_REPL = {
    "full": {
        "uniform": (dict(strategy="replicated", P=8, replicate=2,
                         replica_shards=4, schedule_kind="replicated",
                         schedule_K=2, overlap=False, volume_rows=370553,
                         volume_rows_padded=376528,
                         modeled_time_replicated=0.0009395046684444445,
                         modeled_time_replicated_c2=0.0009395046684444445,
                         modeled_time_replicated_c4=0.002736019968,
                         modeled_time_unreplicated=0.00312929024,
                         pattern_nnz=1166229),
                    dict(c=2, s=4, R_b=16232, R_c=46413,
                         lane_shifts=((3,), (1, 2)),
                         rounds=(((3, 1), 8093, 23394, 0, 0, (0, 1), (0, 1)),
                                 ((0, 2), 8139, 23019, 8093, 23394, (1,),
                                  (1,))))),
        "power_law": (dict(strategy="replicated", P=8, replicate=2,
                           replica_shards=4, schedule_kind="replicated",
                           schedule_K=2, overlap=False, volume_rows=170538,
                           volume_rows_padded=355900,
                           modeled_time_replicated=0.0009964943502222222,
                           modeled_time_replicated_c2=0.0009964943502222222,
                           modeled_time_replicated_c4=0.002757821240888889,
                           modeled_time_unreplicated=0.004371014656,
                           pattern_nnz=1116853),
                      dict(c=2, s=4, R_b=16794, R_c=40228,
                           lane_shifts=((3,), (1, 2)),
                           rounds=(((3, 1), 9862, 22091, 0, 0, (0, 1),
                                    (0, 1)),
                                   ((0, 2), 6932, 18137, 9862, 22091, (1,),
                                    (1,))))),
    },
    "quick": {
        "uniform": (dict(strategy="replicated", P=8, replicate=2,
                         replica_shards=4, schedule_kind="replicated",
                         schedule_K=2, overlap=False, volume_rows=36280,
                         volume_rows_padded=37324,
                         modeled_time_replicated=0.00010727158044444443,
                         modeled_time_replicated_c2=0.00010727158044444443,
                         modeled_time_replicated_c4=0.00028390525155555556,
                         modeled_time_unreplicated=0.000340499712,
                         pattern_nnz=114659),
                    dict(c=2, s=4, R_b=1651, R_c=4546,
                         lane_shifts=((1,), (2, 3)),
                         rounds=(((1, 2), 838, 2296, 0, 0, (0, 1), (0, 1)),
                                 ((0, 3), 813, 2250, 838, 2296, (1,),
                                  (1,))))),
        "power_law": (dict(strategy="replicated", P=8, replicate=2,
                           replica_shards=4, schedule_kind="replicated",
                           schedule_K=2, overlap=False, volume_rows=17789,
                           volume_rows_padded=37528,
                           modeled_time_replicated=0.00011250460444444444,
                           modeled_time_replicated_c2=0.00011250460444444444,
                           modeled_time_replicated_c4=0.0002794613191111111,
                           modeled_time_unreplicated=0.000526092672,
                           pattern_nnz=107248),
                      dict(c=2, s=4, R_b=1825, R_c=4165,
                           lane_shifts=((3,), (1, 2)),
                           rounds=(((3, 1), 1079, 2313, 0, 0, (0, 1),
                                    (0, 1)),
                                   ((0, 2), 746, 1852, 1079, 2313, (1,),
                                    (1,))))),
    },
}
# phases 8 and 9 run on a quarter of arxiv (LIFE_SCALE,
# ``life_matrices``): the reference's rungs of SpmmSession.build(power-law
# quarter, 8, SpmmConfig(hier="auto"), p_ladder=(4, 8)) there
# (scripts/reference_phase9_pins.py: the JAX package's session, CPU run)
EXPECT_SERVE_LADDER = {
    "full": {
        8: dict(strategy="hier", P=8, G=2, L=4, schedule_kind="bucketed",
                schedule_K=1, overlap=True,
                modeled_time_flat=0.0008363829013333333,
                modeled_time_hier=0.000155923168, volume_rows=67604,
                volume_rows_padded=45904, volume_rows_padded_single=115712,
                pattern_nnz=275818),
        4: dict(strategy="flat", P=4, schedule_kind="bucketed", schedule_K=1,
                overlap=True, modeled_time_flat=3.0229052444444446e-05,
                modeled_time_hier=0.000268717728, volume_rows=44066,
                volume_rows_padded=99144, volume_rows_padded_single=132192,
                pattern_nnz=275818),
    },
    "quick": {
        8: dict(strategy="hier", P=8, G=2, L=4, schedule_kind="bucketed",
                schedule_K=1, overlap=True,
                modeled_time_flat=0.00015025640888888893,
                modeled_time_hier=3.444848e-05, volume_rows=7229,
                volume_rows_padded=4776, volume_rows_padded_single=12096,
                pattern_nnz=26301),
        4: dict(strategy="flat", P=4, schedule_kind="bucketed", schedule_K=1,
                overlap=True, modeled_time_flat=8.454272e-06,
                modeled_time_hier=4.6159872e-05, volume_rows=4667,
                volume_rows_padded=10284, volume_rows_padded_single=13712,
                pattern_nnz=26301),
    },
}
# phase 9's fleet tenants: h1 is the quarter power-law matrix, h2 a second
# one of that size and lt a 16,384-node one (--quick: 1,024 nodes, below
# its heavies); their pattern fingerprints place all three on group 0
FLEET_H2_SEED = 1
FLEET_LIGHT = dict(m=16_384, nnz=7 * 16_384, seed=0)
FLEET_LIGHT_QUICK = dict(m=1024, nnz=7 * 1024, seed=0)
# the reference's SpmmFleet on them (Topology.local(8) split (4, 4),
# SpmmConfig(n_dense_hint=128), admitted in either order) and on the
# quarter uniform matrix (split (4, 2), backends=("bsr", "coo"),
# p_ladder=(2, 4)): scripts/reference_phase9_pins.py (the JAX package's
# admit / rebalance / migrate and ReshardSpec, CPU run, host planning)
EXPECT_FLEET = dict(
    placements={"h1": 0, "h2": 0, "lt": 0},
    scores={"h1": {0: (3.220096e-05, 47410796), 1: (3.220096e-05, 47410796)},
            "h2": {0: (3.2187306666666665e-05, 47406368),
                   1: (3.2187306666666665e-05, 47406368)},
            "lt": {0: (1.5578026666666666e-05, 19042432),
                   1: (1.5578026666666666e-05, 19042432)}},
    imbalance=(2.0, 0.38927334717027434),
    moves=[("h1", 1)], moved={"b_rows": 0, "c_rows": 0},
    cross=dict(group=0, scores={0: (3.133056e-05, 53001896),
                                1: (4.496568888888889e-05, 79993644)},
               P=(4, 2), moved={"b_rows": 31752, "c_rows": 31752}),
)
GAT_DIMS = dict(feat_dim=128, hidden=128, n_classes=40, n_layers=2,
                att_dim=16)  # ogbn-arxiv's features and classes
SDDMM_F = 128

LM_ARCH = "olmoe-1b-7b"  # the config the repo calls SHIRO-first-class
LM_PREFILL = (8, 128)  # prompts x tokens of the prefill forward
# more requests than slots: two waves; prompts of 8-16 tokens (32-64
# before the script outgrew its time limit: each prompt token is a step)
LM_SERVE = dict(max_batch=8, max_len=128, requests=12, prompt=(8, 16),
                new_tokens=16)
LM_F32 = dict(n_layers=2, batch=2, tokens=16)  # the float32 / float64 copy
DISPATCH = dict(tokens=1024, M=8)  # one 8 x 128 prefill's MoE dispatch
# the reference's dispatch decisions (repro.models.moe.compile_dispatch(
# get_config("olmoe-1b-7b"), 1024, 8).stats(), JAX package, CPU run)
EXPECT_DISPATCH = dict(strategy="flat", plan_strategy="joint", net="tsubame4",
                       shape=(8424, 1024), backends=("coo",),
                       schedule_kind="bucketed", schedule_K=1, overlap=True,
                       modeled_time_schedule=5.1539199999999996e-05,
                       volume_rows=4917, volume_rows_padded=6160,
                       volume_rows_padded_single=7040, pattern_nnz=8192)

KERNELS = {
    # name: (source, the Pallas function it replaces)
    "gather_rows": ("src/repro_torch/csrc/gather_rows.cu",
                    "src/repro/kernels/gather_rows.py:34"),
    # K1's scaled form: the coo gather with the multiply by the values
    "gather_rows_scaled": ("src/repro_torch/csrc/gather_rows.cu",
                           "src/repro/kernels/gather_rows.py:34"),
    "scatter_add_rows": ("src/repro_torch/csrc/scatter_add_rows.cu",
                         "src/repro/kernels/scatter_add_rows.py:71"),
    "bsr_spmm": ("src/repro_torch/csrc/bsr_spmm.cu",
                 "src/repro/kernels/bsr_spmm.py:53"),
    "bsr_spmm_acc": ("src/repro_torch/csrc/bsr_spmm.cu",
                     "src/repro/kernels/bsr_spmm.py:110"),
    "bsr_sddmm": ("src/repro_torch/csrc/bsr_sddmm.cu",
                  "src/repro/kernels/sddmm.py:72"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:33"),
    # K6's backward: the reference differentiates its jnp rms_norm
    # (models/layers.py:26-28) through XLA; no Pallas backward exists
    "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:33"),
}


# the kernels whose profiler busy time a row reports: {kernel row: the
# substrings of its device kernels' names}. K6's forward is one kernel a
# call: rmsnorm_kernel_rows where the lanes hold the row, rmsnorm_kernel
# (the wide one) past that, so a path of one width finds the one it
# launched. K6's backward is a pair (its rows, then the fold of the dg
# partials); "rmsnorm_kernel" names no backward kernel.
BUSY_KERNELS = {"rmsnorm": ("rmsnorm_kernel",),
                "rmsnorm_bwd": ("rmsnorm_bwd", "rmsnorm_dg")}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def toolchain() -> str:
    from repro_torch.kernels.build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    return (f"torch {torch.__version__}, torch.version.cuda "
            f"{torch.version.cuda}, nvcc: {nvcc[-1]}, triton {triton_version}")


def host_rss_gb() -> float:
    """This process's resident host memory (Linux ``/proc``), GB."""
    with open("/proc/self/status") as f:
        kb = next(int(line.split()[1]) for line in f
                  if line.startswith("VmRSS:"))
    return kb / 1e6


def release_host_memory() -> None:
    """Hand freed host memory back: Python's garbage, torch's cache of
    pinned blocks and the C heap's free pages (glibc ``malloc_trim``)."""
    import ctypes

    gc.collect()
    torch.cuda.empty_cache()
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


def peak_allocated() -> int:
    """The card's peak allocated bytes since the last ``reset_peak``, the
    peaks that the handles' memory records reset away included."""
    from repro_torch.launch import memory

    return memory.peak_allocated()


def reset_peak() -> None:
    from repro_torch.launch import memory

    memory.reset_peak()


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us_per_launch(runs, n: int = 200) -> float:
    """Host wall time per wrapper call, in µs, over ``n`` back-to-back
    calls (the path's recorded calls in turn): the clock stops when the
    n-th call returns, before the one sync at the end, so it reads the
    launch path's host cost even where the kernels take longer."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(n):
        runs[j % len(runs)]()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / n * 1e6


def _kernel_base(key: str) -> str:
    """A profiler kernel key's function name without namespace, template
    arguments or parameters (``void ns::k<..>(..)`` -> ``k``)."""
    m = re.search(r"(\w+)(?:<|\()", key)
    return m.group(1) if m else key


def kernel_busy_ms(fns, keys, reps: int = 5, sessions: int = 4):
    """Device time of the kernels whose names hold one of ``keys``, under
    torch.profiler, per pass over ``fns`` (each one call that launches
    each of those kernels once, called ``reps`` times): ({kernel: ms},
    the share of the launches whose records the counted session kept).
    One entry per kernel function, the kernel's own time, without the
    host time between launches that CUDA events count. A profiler session
    can lose device records (all of them, or a share: 10 of 25, 0 of 100
    and 367 of 400 in three sessions of one run of this script), so a
    session counts when it saw every launch of every kernel; up to
    ``sessions`` are tried, each four times as long as the one before.
    Each key names one kernel function. When no session saw every launch,
    the most complete one counts if it kept at least half of each
    kernel's launches: each kernel's mean over the records it kept, times
    its launches in a pass. Otherwise this fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen, best = [], None
    for attempt in range(sessions):
        if attempt:
            reps *= 4
        want = reps * len(fns)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for fn in fns:
                    fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and any(
                    k in e.key for k in keys):
                n, us = by.get(_kernel_base(e.key), (0, 0.0))
                by[_kernel_base(e.key)] = (n + e.count,
                                           us + e.self_device_time_total)
        # one kernel function a key, each at most once a call, each with a
        # record of its own time
        kept = min((n for n, _ in by.values()), default=0) / want
        if len(by) == len(keys) and all(
                n <= want and us > 0 for n, us in by.values()) and (
                best is None or kept > best[0]):
            best = (kept, {k: us / n * len(fns) / 1e3
                           for k, (n, us) in sorted(by.items())})
        if best is not None and best[0] == 1.0:
            return best[1], 1.0
        seen.append(f"{ {k: n for k, (n, _) in by.items()} } of {want}")
        log(f"profiler session {attempt + 1} saw {seen[-1]} {keys} "
            f"launches")
    if best is not None and best[0] >= 0.5:
        log(f"profiler: no session saw every {keys} launch; the mean over "
            f"the records of the most complete one ({best[0]:.3f} of its "
            f"launches) counts")
        return best[1], best[0]
    raise AssertionError(f"the profiler saw {', '.join(seen)} {keys} "
                         f"launches in {sessions} sessions")


# F.rms_norm's device kernel on the card (torch 2.11): the name
# ``library_busy_ms`` falls back on when no profiler session kept a record
LIBRARY_KERNELS = ("vectorized_layer_norm_kernel",)


def library_busy_ms(fns, sessions: int = 4) -> float:
    """Device time of a library call (``fns``: calls of it, as
    ``kernel_busy_ms`` takes them) per pass over ``fns``, under
    torch.profiler: its kernels' names are read from the first of up to
    ``sessions`` sessions (each four times as long as the one before)
    that kept any of their records (else ``LIBRARY_KERNELS``), then timed
    as ``kernel_busy_ms`` times the port's kernels (one launch of each a
    call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names, reps = None, 5
    for attempt in range(sessions):
        if attempt:
            reps *= 4
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for fn in fns:
                    fn()
            torch.cuda.synchronize()
        names = tuple(sorted({_kernel_base(e.key)
                              for e in prof.key_averages()
                              if e.device_type == DeviceType.CUDA
                              and e.count}))
        if names:
            break
        log(f"profiler session {attempt + 1} kept no record of the library "
            f"call's kernels")
    by, _ = kernel_busy_ms(fns, names or LIBRARY_KERNELS)
    return sum(by.values())


# ---------------------------------------------------------------------------
# kernel calls: record on the main path, replay against the plain versions
# ---------------------------------------------------------------------------


def _kernel_targets():
    """{kernel: (its module, its CUDA wrapper's name)}."""
    from repro_torch.kernels import (
        bsr_spmm, gather_rows, rmsnorm, scatter_add_rows, sddmm,
    )

    return {"gather_rows": (gather_rows, "gather_rows_cuda"),
            "gather_rows_scaled": (gather_rows, "gather_rows_scaled_cuda"),
            "scatter_add_rows": (scatter_add_rows, "scatter_add_rows_cuda"),
            "bsr_spmm": (bsr_spmm, "bsr_spmm_cuda"),
            "bsr_spmm_acc": (bsr_spmm, "bsr_spmm_acc_cuda"),
            "bsr_sddmm": (sddmm, "bsr_sddmm_cuda"),
            "rmsnorm": (rmsnorm, "rmsnorm_cuda"),
            "rmsnorm_bwd": (rmsnorm, "rmsnorm_bwd_cuda")}


def _with_wrapped(fn, wrap):
    """Run ``fn()`` with every kernel wrapper replaced by ``wrap(kernel,
    original)``; the originals come back afterwards."""
    targets = _kernel_targets()
    originals = {k: getattr(mod, attr) for k, (mod, attr) in targets.items()}
    for k, (mod, attr) in targets.items():
        setattr(mod, attr, wrap(k, originals[k]))
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for k, (mod, attr) in targets.items():
            setattr(mod, attr, originals[k])


class _OnHost:
    """A recorded tensor argument kept in host memory, and the device it
    goes back to for its replay."""

    def __init__(self, t: torch.Tensor):
        self.t, self.device = t.detach().to("cpu", copy=True), t.device

    def back(self) -> torch.Tensor:
        return self.t.to(self.device)


def record_kernel_calls(fn, host: bool = False):
    """Run ``fn()`` with every kernel wrapper wrapped to keep a copy of
    its arguments; returns {kernel: [(args, kwargs), ...]}. With ``host``
    the copies wait in host memory (``_OnHost``) and go back to the card
    one call at a time as they are replayed: a training step's or a
    full-width prefill's calls would crowd the card."""
    calls = {k: [] for k in _kernel_targets()}
    keep = _OnHost if host else (lambda a: a.clone())

    def wrap(kernel, orig):
        def recorded(*args, **kwargs):
            calls[kernel].append((
                [keep(a) if isinstance(a, torch.Tensor) else a
                 for a in args],
                {k: keep(a) if isinstance(a, torch.Tensor) else a
                 for k, a in kwargs.items()}))
            return orig(*args, **kwargs)
        return recorded

    _with_wrapped(fn, wrap)
    return calls


def stream_kernel_calls(fn, keep: int = 8, tallies=None):
    """Run ``fn()`` with every kernel call checked against its plain
    version and timed as it happens, before the call itself runs
    (``KernelTally.add``); returns {kernel: tally} for the kernels that
    ran (added to ``tallies`` when given). Nothing is kept past a call but
    the last ``keep`` replays a kernel (for its host-time loop): a
    training step's calls at full size would not fit on the card all at
    once."""
    tallies = {} if tallies is None else tallies
    busy = []

    def wrap(kernel, orig):
        def streamed(*args, **kwargs):
            if not busy:  # the replays call the original directly
                busy.append(kernel)
                try:
                    tallies.setdefault(kernel, KernelTally(kernel, keep)
                                       ).add(args, kwargs)
                finally:
                    busy.pop()
            return orig(*args, **kwargs)
        return streamed

    _with_wrapped(fn, wrap)
    return tallies


def _distinct_rows(idx: torch.Tensor) -> int:
    """Distinct non-negative entries per rank, summed over ranks."""
    P_ = idx.shape[0]
    total = 0
    for p in range(P_):
        row = idx[p].reshape(-1)
        total += int(torch.unique(row[row >= 0]).numel())
    return total


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _bsr_csr(cols, blocks, K: int, m_out: int):
    """The stacked ELL pieces as one block-diagonal CSR matrix (for the
    library call): [P*m_out, P*K]."""
    P_, mb, t, bm, bk = blocks.shape
    p, i, s, r, k = (blocks != 0).nonzero().unbind(1)
    c = cols[p, i, s].long()
    row = i * bm + r
    col = c * bk + k
    keep = (row < m_out) & (col < K)
    idx = torch.stack([p * m_out + row, p * K + col])[:, keep]
    with warnings.catch_warnings():  # beta-state notices of torch.sparse
        warnings.simplefilter("ignore")
        coo = torch.sparse_coo_tensor(idx, blocks[p, i, s, r, k][keep],
                                      (P_ * m_out, P_ * K)).coalesce()
        return coo.to_sparse_csr()


def _sddmm_csr(cols, blocks, rows: int, ncols: int):
    """The stored nonzeros of stacked ELL pieces as one block-diagonal CSR
    pattern [P*rows, P*ncols] carrying the stored values (the library's
    SDDMM samples at exactly these positions)."""
    P_, mb, t, bm, bk = blocks.shape
    p, i, s, r, k = (blocks != 0).nonzero().unbind(1)
    idx = torch.stack([p * rows + i * bm + r,
                       p * ncols + cols[p, i, s].long() * bk + k])
    with warnings.catch_warnings():  # beta-state notices of torch.sparse
        warnings.simplefilter("ignore")
        coo = torch.sparse_coo_tensor(idx, blocks[p, i, s, r, k],
                                      (P_ * rows, P_ * ncols)).coalesce()
        return coo.to_sparse_csr()


def bf16_ulp(y: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |y| (8 significant bits)."""
    mag = y.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_rmsnorm(out: torch.Tensor, plain: torch.Tensor, x: torch.Tensor,
                  g: torch.Tensor, eps: float, rbg: bool) -> float:
    """K6 against its plain version, which repeats the kernel's float32
    chain (the same bits), and against the oracle ``rmsnorm_ref`` (torch's
    own order of the sum of squares): float32 within 1e-5, bfloat16 within
    one ulp of |y| — and with two roundings (``rbg``) one ulp of the
    rounded x·r carried through the gain on top, since r's last float32
    bit can move cast(x·r) by one bf16 ulp. Returns the max abs
    difference from the oracle."""
    from repro_torch.kernels.ref import rmsnorm_ref

    if not torch.equal(out, plain):
        raise AssertionError("rmsnorm kernel != plain version (same chain)")
    ref = rmsnorm_ref(x, g, eps, round_before_gain=rbg)
    diff = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        return float(diff.max())
    tol = bf16_ulp(torch.maximum(out.float().abs(), ref.float().abs()))
    if rbg:
        xf = x.float()
        inter = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
                 ).to(torch.bfloat16)
        tol = tol + bf16_ulp(inter) * g.float().abs()
    if not bool((diff <= tol).all()):
        raise AssertionError(f"rmsnorm kernel differs from the oracle beyond "
                             f"the bf16 tolerance: {diff.max()}")
    return float(diff.max())


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bit patterns of a float32 / bfloat16 tensor (-0.0 != +0.0)."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def replay_call(name, args, kw):
    """One recorded call of kernel ``name``, checked against the plain
    version: (out, ref, run, plain, lib, pair, nbytes, flops, oracle).
    A function of its own, so that each call's closures keep their own
    arguments."""
    import torch.nn.functional as F

    from repro_torch.kernels import bsr_spmm as k34
    from repro_torch.kernels import gather_rows as k1
    from repro_torch.kernels import rmsnorm as k6
    from repro_torch.kernels import scatter_add_rows as k2
    from repro_torch.kernels import sddmm as k5

    oracle = 0.0
    pair = None
    if name == "gather_rows_scaled":
        b, idx, val, out_dtype = args
        out = k1.gather_rows_scaled_cuda(b, idx, val, out_dtype)
        ref = k1.gather_rows_scaled_plain(b, idx, val, out_dtype)
        if not torch.equal(_bits(out), _bits(ref)):
            raise AssertionError("gather_rows_scaled kernel != plain "
                                 "version")
        P_, K, n = b.shape
        flat = torch.where(idx >= 0, idx.long() + torch.arange(
            P_, device=b.device)[:, None] * K, P_ * K).reshape(-1)
        b_pad = torch.cat([b.reshape(P_ * K, n), b.new_zeros(1, n)])
        v2 = val.reshape(-1, 1)
        run = lambda: k1.gather_rows_scaled_cuda(b, idx, val, out_dtype)  # noqa: E731,E501
        plain = lambda: k1.gather_rows_scaled_plain(b, idx, val, out_dtype)  # noqa: E731,E501
        # no one library call: index_select, then the multiply
        lib = lambda: (b_pad.index_select(0, flat) * v2).to(out_dtype)  # noqa: E731,E501
        # the former coo path: K1's pack form, then the multiply
        pair = lambda: (k1.gather_rows_cuda(b, idx) * val[..., None]).to(out_dtype)  # noqa: E731,E501
        es = b.element_size()
        nbytes = (_distinct_rows(idx) * n * es + 2 * idx.numel() * 4
                  + idx.numel() * n * out.element_size())
        flops = float(idx.numel() * n)
    elif name == "gather_rows":
        b, idx = args
        out = k1.gather_rows_cuda(b, idx)
        ref = k1.gather_rows_plain(b, idx)
        if not torch.equal(_bits(out), _bits(ref)):
            raise AssertionError("gather_rows kernel != plain version")
        P_, K, n = b.shape
        flat = torch.where(idx >= 0, idx.long() + torch.arange(
            P_, device=b.device)[:, None] * K, P_ * K).reshape(-1)
        b_pad = torch.cat([b.reshape(P_ * K, n), b.new_zeros(1, n)])
        run = lambda: k1.gather_rows_cuda(b, idx)  # noqa: E731
        plain = lambda: k1.gather_rows_plain(b, idx)  # noqa: E731
        lib = lambda: b_pad.index_select(0, flat)  # noqa: E731
        es = b.element_size()
        nbytes = (_distinct_rows(idx) * n * es + idx.numel() * 4
                  + idx.numel() * n * es)
        flops = 0.0
    elif name == "scatter_add_rows":
        c0, parts, perm, meta = args
        out = k2.scatter_add_rows_cuda(c0.clone(), parts, perm, meta)
        ref = k2.scatter_add_rows_plain(c0.clone(), parts, perm, meta)
        if not torch.equal(out, ref):  # one slot-order chain in both
            raise AssertionError("scatter_add_rows kernel != plain "
                                 "version")
        P_, S, n = parts.shape
        M = c0.shape[1]
        c = c0.clone()
        valid = torch.arange(S, device=c.device)[None] < meta[:, S:]
        tgt = (meta[:, :S].long() + torch.arange(
            P_, device=c.device)[:, None] * M)[valid]
        rows = torch.take_along_dim(parts, perm.long()[..., None],
                                    dim=1)[valid]
        run = lambda: k2.scatter_add_rows_cuda(c, parts, perm, meta)  # noqa: E731,E501
        plain = lambda: k2.scatter_add_rows_plain(c, parts, perm, meta)  # noqa: E731,E501
        lib = lambda: c.view(P_ * M, n).index_add_(0, tgt, rows)  # noqa: E731,E501
        es = c.element_size()
        n_valid = int(valid.sum())
        touched = int(torch.unique(tgt).numel())
        nbytes = (n_valid * n * es + (perm.numel() + meta.numel()) * 4
                  + 2 * touched * n * es)
        flops = float(n_valid * n)
    elif name == "rmsnorm":
        x, g, eps = args
        rbg = kw["round_before_gain"]
        out = k6.rmsnorm_cuda(x, g, eps, round_before_gain=rbg)
        ref = k6.rmsnorm_plain(x, g, eps, round_before_gain=rbg)
        oracle = check_rmsnorm(out, ref, x, g, eps, rbg)
        # under grad the call also writes r for the backward: y the same
        # bits as without, r the plain version's
        opt = {"return_r": True} if kw.get("return_r") else {}
        if opt:
            y, r = k6.rmsnorm_cuda(x, g, eps, round_before_gain=rbg, **opt)
            _, pr = k6.rmsnorm_plain(x, g, eps, round_before_gain=rbg, **opt)
            if not (torch.equal(y, out) and torch.equal(r, pr)):
                raise AssertionError("rmsnorm kernel writing r: y or r != "
                                     "the launch without r / the plain r")
        with_r = bool(opt)  # the same call shape as the run without r
        run = lambda: k6.rmsnorm_cuda(x, g, eps, round_before_gain=rbg, return_r=with_r)  # noqa: E731,E501
        plain = lambda: k6.rmsnorm_plain(x, g, eps, round_before_gain=rbg, **opt)  # noqa: E731,E501
        lib = lambda: F.rms_norm(x, (x.shape[-1],), weight=g, eps=eps)  # noqa: E731,E501
        es = x.element_size()
        # read x, g; write y (and r, one float32 a row)
        nbytes = 2 * x.numel() * es + g.numel() * es + (
            x.numel() // x.shape[-1] * 4 if opt else 0)
        flops = 4.0 * x.numel()  # square-add, scale, gain (+ rounding)
    elif name == "rmsnorm_bwd":
        x, g, dy, eps = args
        rbg = kw["round_before_gain"]
        # the forward's saved r, as the main path passes it
        opt = {"r": kw["r"]} if kw.get("r") is not None else {}
        out = torch.cat([t.reshape(-1) for t in k6.rmsnorm_bwd_cuda(
            x, g, dy, eps, round_before_gain=rbg, **opt)])
        ref = torch.cat([t.reshape(-1) for t in k6.rmsnorm_bwd_plain(
            x, g, dy, eps, round_before_gain=rbg, **opt)])
        if not torch.equal(out, ref):  # one chain, fixed fold orders
            raise AssertionError("rmsnorm_bwd kernel != plain version")
        if opt and not torch.equal(out, torch.cat([
                t.reshape(-1) for t in k6.rmsnorm_bwd_cuda(
                    x, g, dy, eps, round_before_gain=rbg)])):
            raise AssertionError("rmsnorm_bwd kernel: the saved r and r "
                                 "formed in the forward's chain differ")
        run = lambda: k6.rmsnorm_bwd_cuda(x, g, dy, eps, round_before_gain=rbg, **opt)  # noqa: E731,E501
        plain = lambda: k6.rmsnorm_bwd_plain(x, g, dy, eps, round_before_gain=rbg, **opt)  # noqa: E731,E501
        # the library's RMSNorm backward alone: F.rms_norm's graph built
        # once, each call one autograd backward through it
        xl = x.detach().requires_grad_(True)
        gl = g.detach().requires_grad_(True)
        yl = F.rms_norm(xl, (x.shape[-1],), weight=gl, eps=eps)
        lib = lambda: torch.autograd.grad(yl, (xl, gl), dy, retain_graph=True)  # noqa: E731,E501
        es = x.element_size()
        # read x, dy, g (and r); write dx, dg (the float32 partials are
        # scratch)
        nbytes = 3 * x.numel() * es + 2 * g.numel() * es + (
            x.numel() // x.shape[-1] * 4 if opt else 0)
        flops = 10.0 * x.numel()
    elif name == "bsr_sddmm":
        cols, blocks, x3, y3 = args
        out = k5.bsr_sddmm_cuda(cols, blocks, x3, y3)
        ref = k5.bsr_sddmm_plain(cols, blocks, x3, y3)
        if not torch.equal(out, ref):  # one FMA chain in both
            raise AssertionError("bsr_sddmm kernel != plain version")
        P_, mb, t, bm, bk = blocks.shape
        kb, f = y3.shape[1], y3.shape[3]
        csr = _sddmm_csr(cols, blocks, mb * bm, kb * bk)
        x2 = x3.reshape(P_ * mb * bm, f)
        y2t = y3.reshape(P_ * kb * bk, f).t()
        stored = csr.values()
        run = lambda: k5.bsr_sddmm_cuda(cols, blocks, x3, y3)  # noqa: E731
        plain = lambda: k5.bsr_sddmm_plain(cols, blocks, x3, y3)  # noqa: E731,E501
        lib = lambda: torch.sparse.sampled_addmm(  # noqa: E731
            csr, x2, y2t, beta=0.0).values() * stored
        # what this run's data needs: every stored block read and
        # every slot written once, the X and Y rows of the stored
        # nonzeros read once, 2F + 1 operations per stored nonzero
        es = x3.element_size()
        valid = (cols >= 0) & (cols < kb)
        nb = int(valid.sum())
        p, i, s, r, c = (blocks.ne(0) & valid[..., None, None]
                         ).nonzero().unbind(1)
        x_rows = torch.unique((p * mb + i) * bm + r).numel()
        y_rows = torch.unique((p * kb + cols[p, i, s].long()) * bk
                              + c).numel()
        flops = float(p.numel() * (2 * f + 1))
        nbytes = (nb * bm * bk * 4 + cols.numel() * 4
                  + (x_rows + y_rows) * f * es + out.numel() * 4)
    else:
        acc_form = name == "bsr_spmm_acc"
        cols, blocks, b, last = args
        bn = kw.get("bn", 128)
        P_, mb, t, bm, bk = blocks.shape
        K, n = b.shape[1], b.shape[2]
        m_out = last.shape[1] if acc_form else int(last)
        if acc_form:
            out = k34.bsr_spmm_acc_cuda(cols, blocks, b, last.clone(),
                                        bn=bn)
            ref = k34.bsr_spmm_acc_plain(cols, blocks, b, last.clone())
            acc = last.clone()
            run = lambda: k34.bsr_spmm_acc_cuda(cols, blocks, b, acc, bn=bn)  # noqa: E731,E501
            plain = lambda: k34.bsr_spmm_acc_plain(cols, blocks, b, acc)  # noqa: E731,E501
        else:
            out = k34.bsr_spmm_cuda(cols, blocks, b, m_out, bn=bn)
            ref = k34.bsr_spmm_plain(cols, blocks, b, m_out)
            run = lambda: k34.bsr_spmm_cuda(cols, blocks, b, m_out, bn=bn)  # noqa: E731,E501
            plain = lambda: k34.bsr_spmm_plain(cols, blocks, b, m_out)  # noqa: E731,E501
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        csr = _bsr_csr(cols, blocks, K, m_out)
        b2 = b.reshape(P_ * K, n)
        if acc_form:
            acc2 = last.reshape(P_ * m_out, n)
            lib = lambda: torch.addmm(acc2, csr, b2)  # noqa: E731
        else:
            lib = lambda: torch.sparse.mm(csr, b2)  # noqa: E731
        es = b.element_size()
        nb = int((cols >= 0).sum())
        flops = 2.0 * nb * bm * bk * n
        nbytes = (nb * bm * bk * 4 + cols.numel() * 4
                  + _distinct_rows(cols) * bk * n * es
                  + P_ * m_out * n * es * (2 if acc_form else 1))
    return out, ref, run, plain, lib, pair, nbytes, flops, oracle


class KernelTally:
    """``kernel_row``'s sums over one kernel's calls, taken one call at a
    time (``add``), so a caller can check and time each call as it
    happens; ``keep`` bounds the calls kept for the host-time loop (None:
    all of them)."""

    def __init__(self, name, keep=None):
        self.name, self.n = name, 0
        self.err = self.ms = self.plain_ms = self.lib_ms = 0.0
        self.bound_ms = self.oracle_err = self.pair_ms = 0.0
        self.runs = collections.deque(maxlen=keep)
        # K6: its library calls, and under grad the same calls without r
        self.libs = collections.deque(maxlen=keep)
        self.runs_without_r = collections.deque(maxlen=keep)
        self.by = {"bytes": 0.0, "operations": 0.0}

    def add(self, args, kw):
        out, ref, run, plain, lib, pair, nbytes, flops, oracle = replay_call(
            self.name, args, kw)
        self.n += 1
        self.oracle_err = max(self.oracle_err, oracle)
        self.err = max(self.err, float((out.float() - ref.float()).abs()
                                       .max()) if out.numel() else 0.0)
        self.ms += time_ms(run)
        self.runs.append(run)
        if self.name == "rmsnorm":
            self.libs.append(lib)  # F.rms_norm, for its busy time
            if kw.get("return_r"):
                from repro_torch.kernels import rmsnorm as k6

                x, g, eps = args
                rbg = kw["round_before_gain"]
                self.runs_without_r.append(
                    lambda: k6.rmsnorm_cuda(x, g, eps, round_before_gain=rbg,
                                            return_r=False))
        # warm from the check
        self.plain_ms += time_ms(plain, iters=1, warmup=0)
        self.lib_ms += time_ms(lib)
        if pair is not None:
            self.pair_ms += time_ms(pair)
        b_ms, b_by = _bound(nbytes, flops)
        self.bound_ms += b_ms
        self.by[b_by] += b_ms

    def row(self, launches, busy: bool = True):
        """The kernel's JSON row; ``busy=False`` leaves out the profiler
        busy times of K6 and its backward (``BUSY_KERNELS``; phase 10's
        streamed calls: in one run the profiler missed 7 of their K6
        records in each of three sessions)."""
        name, runs = self.name, list(self.runs)
        if not self.n:
            raise AssertionError(f"{name}: no call recorded on the main path")
        source, replaces = KERNELS[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": int(launches),
               "max_abs_err": self.err, "ms": self.ms,
               "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
               "bound_by": max(self.by, key=self.by.get),
               "library_ms": self.lib_ms, "calls_per_h": self.n,
               "host_us_per_launch": host_us_per_launch(runs)}
        if name == "gather_rows_scaled":
            row["library"] = "index_select + mul"
            row["pack_plus_multiply_ms"] = self.pair_ms
        if name == "rmsnorm":
            row["max_abs_err_vs_oracle"] = self.oracle_err
        if self.runs_without_r:
            row["host_us_per_launch_without_r"] = host_us_per_launch(
                list(self.runs_without_r))
        if name in BUSY_KERNELS and busy:
            # each kernel of the call by its own name, and their sum
            by, kept = kernel_busy_ms(runs, BUSY_KERNELS[name])
            row["kernel_busy_ms"] = sum(by.values())
            row["kernel_busy_ms_by_kernel"] = by
            row["kernel_busy_calls"] = len(runs)  # the last <= 8 calls
            # the same launches all on the last call's input, which then
            # stays in L2: the busy time before each call's replay kept its
            # own input
            one, kept_one = kernel_busy_ms([runs[-1]] * len(runs),
                                           BUSY_KERNELS[name])
            row["kernel_busy_ms_one_input"] = sum(one.values())
            # below 1 where no profiler session kept every record
            row["kernel_busy_records_kept"] = [kept, kept_one]
            if name == "rmsnorm":
                # F.rms_norm's device time on the same calls' inputs
                row["library_busy_ms"] = library_busy_ms(list(self.libs))
        return row


def kernel_row(name, calls, launches, busy: bool = True):
    """Replay one kernel's recorded calls: error vs plain, times, bound
    (``busy``: see ``KernelTally.row``). Calls recorded to the host go
    back to the card one at a time."""
    tally = KernelTally(name, keep=8)
    for args, kw in calls:
        tally.add([a.back() if isinstance(a, _OnHost) else a for a in args],
                  {k: a.back() if isinstance(a, _OnHost) else a
                   for k, a in kw.items()})
    return tally.row(launches, busy)


def replay_paths(paths: dict) -> dict:
    """``kernel_row`` for every (kernel, path) of ``paths`` ({kernel:
    {path: (recorded calls, launches)}}): {kernel: {path: row}}."""
    return {k: {path: kernel_row(k, c[k], n[k])
                for path, (c, n) in paths[k].items()} for k in paths}


def kernel_summary(name: str, per_path: dict, card: str) -> dict:
    """One kernel's JSON row: its first path's numbers at the top level,
    each path's own under "paths", max_abs_err the worst over them."""
    for path, r in per_path.items():
        log(f"kernel {name} {path} [{card}]: {r['ms']:.4f} ms per call "
            f"of the path over {r['calls_per_h']} launch(es), "
            f"{r['launches']} launch(es) counted, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"host {r['host_us_per_launch']:.2f} us a launch, "
            f"max abs err {r['max_abs_err']:.3g}"
            + (f"; library = index_select + mul; the former K1 pack + "
               f"multiply {r['pack_plus_multiply_ms']:.4f} ms"
               if "pack_plus_multiply_ms" in r else "")
            + (f" (vs the oracle {r['max_abs_err_vs_oracle']:.3g})"
               if "max_abs_err_vs_oracle" in r else "")
            + (f"; kernels busy {r['kernel_busy_ms']:.4f} ms over its last "
               f"{r['kernel_busy_calls']} calls (torch.profiler; "
               f"{json.dumps(r['kernel_busy_ms_by_kernel'])}; "
               f"{r['kernel_busy_ms_one_input']:.4f} ms with the last "
               f"call's input in every launch)"
               if "kernel_busy_ms" in r else "")
            + (f"; library busy {r['library_busy_ms']:.4f} ms over the same "
               f"calls" if "library_busy_ms" in r else "")
            + (f"; host {r['host_us_per_launch_without_r']:.2f} us a launch "
               f"without r" if "host_us_per_launch_without_r" in r else ""))
    row = dict(next(iter(per_path.values())))
    row["max_abs_err"] = max(r["max_abs_err"] for r in per_path.values())
    row["paths"] = {
        path: {key: r[key] for key in (
            "launches", "calls_per_h", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "host_us_per_launch",
            "launches_per_worker",
            "pack_plus_multiply_ms", "max_abs_err_vs_oracle",
            "kernel_busy_ms", "kernel_busy_ms_by_kernel", "kernel_busy_calls",
            "kernel_busy_ms_one_input", "kernel_busy_records_kept",
            "library_busy_ms", "host_us_per_launch_without_r")
            if key in r}
        for path, r in per_path.items()}
    return row


def sparse_ell(P_: int, mb: int, t: int, kb: int, gen):
    """An 8x8 ELL piece like the GAT graph's: one nonzero per stored block,
    every fifth block denser with stored zeros among its entries, slot 2 a
    stored block of zeros, pads in the middle of rows (slots 1, 5, ...)."""
    dev = gen.device
    cols = torch.randint(0, kb, (P_, mb, t), device=dev, generator=gen,
                         dtype=torch.int32)
    cols[..., 1::4] = -1
    blocks = torch.zeros((P_, mb, t, 64), device=dev)
    blocks.scatter_(-1, torch.randint(0, 64, (P_, mb, t, 1), device=dev,
                                      generator=gen),
                    torch.randn((P_, mb, t, 1), device=dev, generator=gen))
    dense = torch.randn((P_, mb, t, 64), device=dev, generator=gen)
    dense *= torch.rand((P_, mb, t, 64), device=dev, generator=gen) < 0.6
    blocks[:, :, 3::5] = dense[:, :, 3::5]
    blocks[:, :, 2] = 0.0
    cols[:, :, 2] = 0
    blocks[cols < 0] = 0.0
    return cols, blocks.view(P_, mb, t, 8, 8)


def sweep_checks() -> None:
    """``tests/test_kernels.py``'s sweeps, with 2 stacked ranks."""
    from repro_torch.kernels import bsr_spmm as k34
    from repro_torch.kernels import gather_rows as k1
    from repro_torch.kernels import rmsnorm as k6
    from repro_torch.kernels import scatter_add_rows as k2
    from repro_torch.kernels import sddmm as k5

    dev = "cuda"
    rng = np.random.default_rng(0)
    worst = {"f32": 0.0, "bf16": 0.0}
    for mb, t, bm, bk, kb, n, bn in [(2, 3, 8, 8, 4, 16, 16),
                                     (3, 2, 16, 8, 5, 32, 16),
                                     (1, 1, 8, 8, 2, 8, 8),
                                     (4, 5, 32, 16, 8, 64, 64),
                                     (2, 4, 8, 32, 4, 128, 128)]:
        cols = rng.integers(-1, kb, size=(2, mb, t)).astype(np.int32)
        blocks = rng.standard_normal((2, mb, t, bm, bk)).astype(np.float32)
        blocks[cols < 0] = 0.0
        b = rng.standard_normal((2, kb * bk, n)).astype(np.float32)
        cols_d = torch.from_numpy(cols).to(dev)
        for dtype, key, tol in [(torch.float32, "f32", 1e-5),
                                (torch.bfloat16, "bf16", 6e-2)]:
            blk = torch.from_numpy(blocks).to(dev, dtype)
            bb = torch.from_numpy(b).to(dev, dtype)
            out = k34.bsr_spmm_cuda(cols_d, blk, bb, mb * bm, bn=bn)
            ref = k34.bsr_spmm_plain(cols_d, blk, bb, mb * bm)
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                       atol=tol)
            acc = torch.randn((2, mb * bm, n), device=dev).to(dtype)
            out = k34.bsr_spmm_acc_cuda(cols_d, blk, bb, acc.clone(), bn=bn)
            ref = k34.bsr_spmm_acc_plain(cols_d, blk, bb, acc.clone())
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                       atol=tol)
            worst[key] = max(worst[key],
                             float((out.float() - ref.float()).abs().max()))
    for K, n, S in [(16, 8, 5), (64, 32, 20), (8, 128, 3), (128, 256, 64),
                    (40, 130, 33), (9, 2048, 7)]:
        b = torch.randn((2, K, n), device=dev)
        idx = torch.from_numpy(
            rng.integers(-1, K, size=(2, S)).astype(np.int32)).to(dev)
        val = torch.randn((2, S), device=dev)
        for bb in (b, b.to(torch.bfloat16)):
            if not torch.equal(_bits(k1.gather_rows_cuda(bb, idx)),
                               _bits(k1.gather_rows_plain(bb, idx))):
                raise AssertionError(f"gather sweep {(K, n, S)} differs")
            for dt in (bb.dtype, torch.float32):
                if not torch.equal(
                        _bits(k1.gather_rows_scaled_cuda(bb, idx, val, dt)),
                        _bits(k1.gather_rows_scaled_plain(bb, idx, val, dt))):
                    raise AssertionError(f"scaled gather sweep {(K, n, S)} "
                                         f"{bb.dtype} -> {dt} differs")
    for M, n, S in [(8, 16, 12), (16, 8, 30), (4, 8, 6), (32, 128, 100)]:
        c = torch.randn((2, M, n), device=dev)
        parts = torch.randn((2, S, n), device=dev)
        prep = [k2.prepare_sorted_scatter(rng.integers(-1, M, size=S))
                for _ in range(2)]
        perm = torch.from_numpy(np.stack([a for a, _ in prep])).to(dev)
        meta = torch.from_numpy(np.stack([m for _, m in prep])).to(dev)
        if not torch.equal(
                k2.scatter_add_rows_cuda(c.clone(), parts, perm, meta),
                k2.scatter_add_rows_plain(c.clone(), parts, perm, meta)):
            raise AssertionError(f"scatter sweep {(M, n, S)} differs")
    perm, meta = k2.prepare_sorted_scatter(np.full(3, -1, np.int32))
    c = torch.ones((1, 4, 8), device=dev)
    out = k2.scatter_add_rows_cuda(
        c.clone(), torch.full((1, 3, 8), 7.0, device=dev),
        torch.from_numpy(perm[None]).to(dev),
        torch.from_numpy(meta[None]).to(dev))
    if not torch.equal(out, c):
        raise AssertionError("all-pad scatter changed C")
    for mb, t, bm, bk, kb, f in [(3, 4, 8, 8, 5, 1), (4, 3, 8, 8, 6, 16),
                                 (2, 5, 8, 8, 4, 33), (3, 2, 8, 8, 3, 128),
                                 (4, 0, 8, 8, 3, 16), (2, 3, 16, 8, 4, 24)]:
        cols = rng.integers(-1, kb, size=(2, mb, t)).astype(np.int32)
        if t:
            cols[:, 0] = -1  # all-pad block rows
        blocks = rng.standard_normal((2, mb, t, bm, bk)).astype(np.float32)
        blocks[cols < 0] = 0.0
        cols_d = torch.from_numpy(cols).to(dev)
        blk = torch.from_numpy(blocks).to(dev)
        x3 = torch.randn((2, mb, bm, f), device=dev)
        y3 = torch.randn((2, kb, bk, f), device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            xs, ys = x3.to(dtype), y3.to(dtype)
            out = k5.bsr_sddmm_cuda(cols_d, blk, xs, ys)
            if not torch.equal(out, k5.bsr_sddmm_plain(cols_d, blk, xs, ys)):
                raise AssertionError(f"bsr_sddmm sweep {(mb, t, bm, bk, kb, f)}"
                                     f" {dtype} differs from plain")
            if out[cols_d < 0].any():
                raise AssertionError("bsr_sddmm pad slots are not zero")
    # sparse blocks at the GAT pieces' ELL shapes (diag, rowp)
    gen = torch.Generator(dev).manual_seed(0)
    for mb, t in ((2646, 18), (7566, 25)):
        cols_d, blk = sparse_ell(P, mb, t, mb, gen)
        x3 = torch.randn((P, mb, 8, 16), device=dev, generator=gen)
        y3 = torch.randn((P, mb, 8, 16), device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            xs, ys = x3.to(dtype), y3.to(dtype)
            out = k5.bsr_sddmm_cuda(cols_d, blk, xs, ys)
            if not torch.equal(out, k5.bsr_sddmm_plain(cols_d, blk, xs, ys)):
                raise AssertionError(f"bsr_sddmm sparse {(P, mb, t)} {dtype} "
                                     f"differs from plain")
            zero = blk == 0
            if out[zero].any() or out[zero].signbit().any():
                raise AssertionError("bsr_sddmm: a stored zero or a pad "
                                     "did not give +0.0")
        del cols_d, blk, x3, y3, out
    # K6 at the LM's shapes (smollm-train 2048 x 576; prefill and
    # olmoe-train 1024 x 2048; decode 8 x 2048) and each layout of its
    # kernels (32 to 256 lanes a row, the wide kernel, one element at a
    # time): y, and y and r from the r-storing launch, the plain
    # version's bits in both chains; the backward without a saved r (its
    # r from the forward's kernel) == the one with it
    bf, f32 = torch.bfloat16, torch.float32
    k6_shapes = [(2048, 576, bf), (1024, 2048, bf), (8, 2048, bf),
                 (7, 1536, bf), (1, 576, f32), (513, 4096, f32),
                 (3, 4100, f32), (2, 8192, bf), (2, 8200, bf), (5, 50, bf)]
    for rows, d, dtype in k6_shapes:
        x = torch.randn((rows, d), device=dev, generator=gen).to(dtype)
        g = torch.randn(d, device=dev, generator=gen).to(dtype)
        dy = torch.randn((rows, d), device=dev, generator=gen).to(dtype)
        for rbg in (False, True):
            y = k6.rmsnorm_cuda(x, g, 1e-5, round_before_gain=rbg)
            y2, r = k6.rmsnorm_cuda(x, g, 1e-5, round_before_gain=rbg,
                                    return_r=True)
            py, pr = k6.rmsnorm_plain(x, g, 1e-5, round_before_gain=rbg,
                                      return_r=True)
            if not (torch.equal(y, py) and torch.equal(y2, py)
                    and torch.equal(r, pr)):
                raise AssertionError(f"rmsnorm sweep {(rows, d, dtype, rbg)}"
                                     f" differs from plain")
            saved = k6.rmsnorm_bwd_cuda(x, g, dy, 1e-5, round_before_gain=rbg,
                                        r=r)
            formed = k6.rmsnorm_bwd_cuda(x, g, dy, 1e-5,
                                         round_before_gain=rbg)
            if not all(torch.equal(a, b) for a, b in zip(saved, formed)):
                raise AssertionError(f"rmsnorm_bwd sweep {(rows, d, dtype)}:"
                                     f" r formed != the saved r")
    log(f"sweeps: K1 exact (both forms, f32 and bf16 b, n up to 2048), "
        f"K2 exact, K3/K4 max abs err "
        f"f32 {worst['f32']:.3g} (tol 1e-5), bf16 {worst['bf16']:.3g} "
        f"(tol 6e-2); K5 == plain bit for bit (F 1, 16, 33, 128, t = 0, "
        f"all-pad rows; sparse blocks at [{P}, 2646, 18] and [{P}, 7566, "
        f"25], F = 16, stored zeros and pads +0.0), f32 and bf16 inputs; "
        f"K6 y and r == plain bit for bit at "
        f"{[(r_, d_) for r_, d_, _ in k6_shapes]}, both chains, and its "
        f"backward with r formed == with r saved")


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def check_c(c: torch.Tensor, a, b_host: np.ndarray, what: str) -> float:
    """C within the executor tolerance (2e-4) of scipy's product in float64."""
    import scipy.sparse as sp

    ref = sp.csr_matrix((a.data.astype(np.float64), a.indices, a.indptr),
                        shape=a.shape) @ b_host.astype(np.float64)
    got = c.double().cpu().numpy()
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: C shape {got.shape} or values bad")
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4,
                               err_msg=what)
    return float(np.abs(got - ref).max())


def _ex_field(h, k: str):
    """An exec-plan size by name; a replicated schedule's lane shifts and
    rounds (as tuples of their fields) under "lane_shifts" / "rounds"."""
    if k == "lane_shifts":
        return h.schedule.rplan.lane_shifts
    if k == "rounds":
        return tuple(dataclasses.astuple(r) for r in h.schedule.rounds)
    return h.ex.meta[k] if k in h.ex.meta else getattr(h.ex, k)


def check_decisions(h, expect: dict, expect_ex: dict, what: str) -> None:
    st = h.stats()
    got = {k: st[k] for k in expect}
    got_ex = {k: _ex_field(h, k) for k in expect_ex}
    log(f"{what} decisions: {json.dumps({**got, **got_ex})}")
    if got != expect or got_ex != expect_ex:
        raise AssertionError(f"{what}: decisions {got} {got_ex} != "
                             f"{expect} {expect_ex}")


def check_rows(h, what: str) -> int:
    """The collectives of the handle's last call carried exactly
    ``volume_rows_padded`` rows: all of them on the flat tier, those of
    the group axis on the hier tier. Returns the hier tier's local-axis
    rows (0 on the flat tier)."""
    want = h.plan.volume_rows_padded(h.schedule)
    axis = "g" if h.strategy == "hier" else None
    if h.comm.rows(axis) != want:
        raise AssertionError(f"{what}: collectives carried "
                             f"{h.comm.rows(axis)} rows, the plan says "
                             f"{want}")
    return h.comm.rows("l")


# ---------------------------------------------------------------------------
# GAT on the fused handle
# ---------------------------------------------------------------------------


def gat_params(seed: int = 0):
    """numpy weights in the reference's ``GAT.init`` layout and scale."""
    from repro_torch.models.gnn import gat_params as draw

    d = GAT_DIMS
    dims = ([d["feat_dim"]] + [d["hidden"]] * (d["n_layers"] - 1)
            + [d["n_classes"]])
    return draw(dims, d["att_dim"], seed)


def fused_oracle(a, q, k, v) -> np.ndarray:
    """scipy float64: ``leaky_relu(a_ij · q_i·k_j)`` on the stored edges,
    then ``@ v``."""
    import scipy.sparse as sp

    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    s = a.data.astype(np.float64) * np.einsum("ef,ef->e", q[rows],
                                              k[a.indices])
    s = np.where(s > 0, s, 0.2 * s)
    return sp.csr_matrix((s, a.indices, a.indptr), shape=a.shape) @ v


def gat_oracle(a, params, feats: np.ndarray) -> np.ndarray:
    """The whole GAT forward in float64."""
    h = feats.astype(np.float64)
    for i, lp in enumerate(params):
        q, k = h @ lp["wq"], h @ lp["wk"]
        v = h @ lp["wv"] + lp["b"]
        h = fused_oracle(a, q, k, v)
        if i < len(params) - 1:
            h = np.maximum(h, 0.0)
    return h


def _host64(t: torch.Tensor) -> np.ndarray:
    return t.detach().double().cpu().numpy()


def check_close(got: torch.Tensor, want: np.ndarray, what: str) -> str:
    """Within 2e-4 (rtol and atol, the executor tolerance) of ``want``."""
    got = _host64(got)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: shape {got.shape} (want {want.shape}) "
                             f"or non-finite values")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4, err_msg=what)
    diff = np.abs(got - want)
    return (f"max abs err {diff.max():.3g} at |want| up to "
            f"{np.abs(want).max():.3g}; max err / (2e-4 + 2e-4·|want|) "
            f"{(diff / (2e-4 + 2e-4 * np.abs(want))).max():.3g} (<= 1 passes)")


def _segment_shift(segments, total: int, device) -> torch.Tensor:
    """The shift d of every slot of a flat segment space (-1 off-segment)."""
    out = torch.full((max(total, 1),), -1, dtype=torch.long, device=device)
    for d, off, slot in segments:
        out[off:off + slot] = d
    return out


def bsr_piece_coords(ex, name: str, piece, k_local: int):
    """Global (row, col) of every stored nonzero of one stacked bsr piece,
    traced through the plan's exchange maps: the routing the executors
    implement, rebuilt here independently of them."""
    cols, blocks = piece["block_cols"], piece["blocks"]
    P_, mb, t, bm, bk = blocks.shape
    p, i, s, r, k = (blocks != 0).nonzero().unbind(1)
    lr, lc = i * bm + r, cols[p, i, s].long() * bk + k
    m_local = ex.meta["m_local"]
    single = ex.schedule.kind == "single"
    if name == "diag":
        return (p, i, s, r, k), p * m_local + lr, p * k_local + lc
    if "G" in ex.meta:
        return hier_piece_coords(ex, name, (p, i, s, r, k), lr, lc,
                                 k_local)
    if name == "colp":  # columns index the received B (= Y) rows
        idx = ex.b_send_idx.long()
        if single:
            q, j = lc // ex.max_b, lc % ex.max_b
            src = idx[q, p, j]
        else:
            d = _segment_shift(ex.meta["b_segments"], ex.meta["R_b"],
                               lc.device)[lc]
            if (d < 0).any():
                raise AssertionError("colp nonzero outside every B segment")
            q = (p - d) % P_
            src = idx[q, lc]
        if (src < 0).any():
            raise AssertionError("colp nonzero on a padding slot")
        return (p, i, s, r, k), p * m_local + lr, q * k_local + src
    rows = ex.c_recv_rows.long()  # rowp: rows index the partial-C rows
    if single:
        dst, j = lr // ex.max_c, lr % ex.max_c
        tgt = rows[dst, p, j]
    else:
        d = _segment_shift(ex.meta["c_segments"], ex.meta["R_c"],
                           lr.device)[lr]
        if (d < 0).any():
            raise AssertionError("rowp nonzero outside every C segment")
        dst = (p + d) % P_
        tgt = rows[dst, lr]
    if (tgt < 0).any():
        raise AssertionError("rowp nonzero on a padding slot")
    return (p, i, s, r, k), dst * m_local + tgt, p * k_local + lc


def _segment_table(segments, total: int, device):
    """Per slot of a segment space: its shift, its segment's offset and
    its segment's width (-1 off every segment)."""
    out = torch.full((3, max(total, 1)), -1, dtype=torch.long, device=device)
    for d, off, slot in segments:
        out[:, off:off + slot] = torch.tensor([[d], [off], [slot]],
                                              device=device)
    return out


def hier_piece_coords(ex, name: str, at, lr, lc, k_local: int):
    """``bsr_piece_coords`` for the two-tier layouts: colp columns index
    the gathered B space (single: (l_src·G + g_src)·max_bg + slot;
    bucketed: segment-major, L·off .. L·(off + slot) per group shift),
    rowp rows the pre-aggregation space (single: dst·max_cg + slot;
    bucketed: shift-major (dg·L + l_dst)·max_cg + slot)."""
    p = at[0]
    G, L = ex.meta["G"], ex.meta["L"]
    m_local, gd = ex.meta["m_local"], p // L
    single = ex.schedule.kind == "single"
    if name == "colp":
        idx = ex.b_group_send_idx.long()
        if single:
            lg, j = lc // ex.max_bg, lc % ex.max_bg
            ls, gs = lg // G, lg % G
            q = gs * L + ls
            src = idx[q, gd, j]
        else:
            # the gathered space of segment (dg, off, slot) starts at L·off
            segs = tuple((d, L * off, L * slot)
                         for d, off, slot in ex.meta["bg_all"])
            dg, base, width = _segment_table(segs, L * ex.meta["R_bg"],
                                             lc.device)[:, lc]
            if (dg < 0).any():
                raise AssertionError("hier colp nonzero outside every B "
                                     "segment")
            slot = width // L
            ls, j = (lc - base) // slot, (lc - base) % slot
            q = ((gd - dg) % G) * L + ls
            src = idx[q, base // L + j]
        if (src < 0).any():
            raise AssertionError("hier colp nonzero on a padding slot")
        return at, p * m_local + lr, q * k_local + src
    rows = ex.c_recv_rows.long()
    gs = p // L
    max_cg = ex.max_cg
    if single:
        dst, j = lr // max_cg, lr % max_cg
        tgt = rows[dst, gs, j]
    else:
        dg, ld, j = lr // (L * max_cg), (lr // max_cg) % L, lr % max_cg
        off = torch.full((G,), -1, dtype=torch.long, device=lr.device)
        for d, o, _ in ex.meta["cg_all"]:
            off[d] = o
        if (off[dg] < 0).any():
            raise AssertionError("hier rowp nonzero outside every C segment")
        dst = ((gs + dg) % G) * L + ld
        tgt = rows[dst, off[dg] + j]
    if (tgt < 0).any():
        raise AssertionError("hier rowp nonzero on a padding slot")
    return at, dst * m_local + tgt, p * k_local + lc


def check_sddmm_values(h, vals, a, x: torch.Tensor, y: torch.Tensor) -> float:
    """The bsr SDDMM values, piece by piece, against float64 a_ij·x_i·y_j
    at the global (i, j) each stored element maps to; the stored values
    at those coordinates must rebuild A exactly, and every other slot of
    the result must be an exact zero."""
    pieces = h.ex.pieces["bsr"]
    k_local = a.shape[1] // h.plan.P
    keys, stored, err = [], [], 0.0
    for name in ("diag", "colp", "rowp"):
        at, g_row, g_col = bsr_piece_coords(h.ex, name, pieces[name], k_local)
        got = vals[name]
        sampled = got[at].double()
        want = pieces[name]["blocks"][at].double() * (
            x[g_row].double() * y[g_col].double()).sum(dim=1)
        torch.testing.assert_close(sampled, want, rtol=2e-4, atol=2e-4,
                                   msg=lambda m: f"sddmm {name}: {m}")
        err = max(err, float((sampled - want).abs().max()))
        mask = torch.ones_like(got, dtype=torch.bool)
        mask[at] = False
        if got[mask].any():
            raise AssertionError(f"sddmm {name}: non-zero value off the "
                                 f"stored nonzeros")
        keys.append(g_row * a.shape[1] + g_col)
        stored.append(pieces[name]["blocks"][at])
    keys, order = torch.sort(torch.cat(keys))
    stored = torch.cat(stored)[order]
    # A's duplicate entries (a self-loop added to a stored diagonal) sum
    # into one block element, in CSR order, as the ELL layout builds them
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(a.indptr))
    want_keys, inv = np.unique(rows * a.shape[1] + a.indices,
                               return_inverse=True)
    want_vals = np.zeros(want_keys.size, np.float32)
    np.add.at(want_vals, inv, a.data)
    if not (torch.equal(keys.cpu(), torch.from_numpy(want_keys))
            and torch.equal(stored.cpu(), torch.from_numpy(want_vals))):
        raise AssertionError("the bsr pieces' stored nonzeros do not rebuild "
                             "A through the exchange maps")
    return err


def fused_layer_fn(hf):
    """``fused_fn(backend, record=None)``: the layer function ``gat_forward``
    takes, through the fused handle ``hf``; with ``record`` a list, each
    call appends (q, k, v, C, the call's collective log)."""
    def fused_fn(backend, record=None):
        def call(q, k, v):
            c = hf(q, k, v, backend=backend)
            if record is not None:
                record.append((q, k, v, c, list(hf.comm.log)))
            return c
        return call
    return fused_fn


def gat_cell(hf, model, feats, adj, b, want, what: str):
    """Phase 5's GAT checks on one fused handle (phase 5b's on the hier
    one): one forward per backend with its kernel calls recorded, then a
    counted forward per backend — every kernel of the backend launched,
    each layer's C and the output within 2e-4 of float64 (``want``), two
    forwards bit-identical, coo vs bsr within 2e-4 — and the fused log's
    pairs (the group axis's on the hier tier) equal the spmm call's, with
    one more exchange per reversed X round. Returns (the layer function,
    {backend: recorded calls}, {backend: launch counts}, {backend: C})."""
    from repro_torch.kernels import ops
    from repro_torch.models.gnn import gat_forward

    fused_fn = fused_layer_fn(hf)
    # the kernel calls one forward per backend makes, before the counted
    # runs
    recorded = {be: record_kernel_calls(
        lambda: gat_forward(model, feats, fused_fn(be)))
        for be in ("bsr", "coo")}
    layer_calls = {"coo": [], "bsr": []}
    outs, launches = {}, {}
    for be in ("coo", "bsr"):
        ops.reset_launch_counts()
        outs[be] = gat_forward(model, feats, fused_fn(be, layer_calls[be]))
        torch.cuda.synchronize()
        launches[be] = ops.launch_counts()
        log(f"{what} {be} forward launches: {json.dumps(launches[be])}")
    missing = [k for k in ("gather_rows", "scatter_add_rows", "bsr_spmm",
                           "bsr_sddmm") if launches["bsr"][k] < 1]
    missing += [f"{k} (coo)" for k in ("gather_rows", "gather_rows_scaled",
                                       "scatter_add_rows")
                if launches["coo"][k] < 1]
    if missing:
        raise AssertionError(f"{what} path did not launch {missing}")
    for be in ("coo", "bsr"):
        for i, (q, k, v, c, _) in enumerate(layer_calls[be]):
            err = check_close(c, fused_oracle(adj, _host64(q), _host64(k),
                                              _host64(v)),
                              f"{what} {be} layer {i} C")
            log(f"  {what} {be} layer {i} (F={q.shape[1]}, N="
                f"{v.shape[1]}): C vs scipy float64: {err}")
        err = check_close(outs[be], want, f"{what} {be} output")
        log(f"  {what} {be} output {list(outs[be].shape)} vs the float64 "
            f"forward: {err}")
        if not torch.equal(gat_forward(model, feats, fused_fn(be)),
                           outs[be]):
            raise AssertionError(f"{what} {be}: two forwards differ")
        log(f"  {what} {be}: two forwards bit-identical")
    log(f"  {what} coo vs bsr: "
        f"{check_close(outs['coo'], _host64(outs['bsr']), what)}")

    # the fused log against the spmm call's on the same plan and schedule
    hier = hf.strategy == "hier"
    hf(b, kernel="spmm", backend="bsr")
    spmm_log = list(hf.comm.log)
    fused_log = layer_calls["bsr"][-1][4]
    on_axis = ((lambda lg: [e for e in lg if e[0].endswith("@g")]) if hier
               else list)
    pairs = lambda lg: {pr for _, prs, _ in on_axis(lg) for pr in prs}  # noqa: E731,E501
    n_extra = (len(hf.ex.meta["cg_segments" if hier else "c_segments"])
               if hf.schedule.kind == "bucketed" else 1)
    n_fused, n_spmm = len(on_axis(fused_log)), len(on_axis(spmm_log))
    if pairs(fused_log) != pairs(spmm_log) or n_fused != n_spmm + n_extra:
        raise AssertionError(f"{what} fused log: {n_fused} exchanges over "
                             f"{len(pairs(fused_log))} pairs; spmm {n_spmm} "
                             f"over {len(pairs(spmm_log))}")
    log(f"  {what} fused log: the spmm call's {len(pairs(spmm_log))} "
        f"{'group ' if hier else 'shift '}pairs, {n_fused} exchanges = spmm "
        f"{n_spmm} + {n_extra} reversed X rounds")
    return fused_fn, recorded, launches, outs


def sddmm_cell(hf, adj, x, y, what: str):
    """The F = 128 SDDMM on bsr through ``hf``: its kernel calls recorded,
    then a counted call (K1 and K5 launched) whose sampled values are
    checked against float64 through the plan's exchange maps. Returns
    (recorded calls, launch counts, values)."""
    from repro_torch.kernels import ops

    calls = record_kernel_calls(
        lambda: hf(x, y, kernel="sddmm", backend="bsr", edge=None))
    ops.reset_launch_counts()
    vals = hf(x, y, kernel="sddmm", backend="bsr", edge=None)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"{what} F={x.shape[1]} bsr launches: {json.dumps(launches)}")
    if min(launches[k] for k in ("gather_rows", "bsr_sddmm")) < 1:
        raise AssertionError(f"{what}: K1 / K5 not launched")
    err = check_sddmm_values(hf, vals, adj, x, y)
    log(f"  {what} F={x.shape[1]}: values max abs err vs float64 {err:.3g} "
        f"(tol 2e-4); the stored nonzeros rebuild A through the plan's "
        f"exchange maps")
    return calls, launches, vals


def check_hier_cell(h, a, b, b_host, what: str):
    """Phase 5b's checks on one hier SpMM handle: a counted run (h(b) per
    backend, then a cache hit), C against scipy float64, group-axis rows
    == ``volume_rows_padded`` on every call, staged == overlapped, call
    == call, coo vs bsr within 2e-4. Returns the counted launches."""
    from repro_torch.core.dist_spmm import hier_spmm
    from repro_torch.kernels import ops

    backends = h.backends
    ops.reset_launch_counts()
    out = {}
    for be in backends:
        out[be] = h(b, backend=be)
        local = check_rows(h, f"{what} {be}")
    hit = h(b, backend=backends[0])
    check_rows(h, f"{what} {backends[0]} (cache hit)")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"{what} main path launches: {json.dumps(launches)}")
    want = ["gather_rows", "gather_rows_scaled", "scatter_add_rows"]
    if "bsr" in backends:
        want += ["bsr_spmm"] + (["bsr_spmm_acc"] if h.overlap else [])
    if min(launches[k] for k in want) < 1:
        raise AssertionError(f"{what}: a kernel was not launched "
                             f"({want}): {launches}")
    b_ig, c_ig = h.hier.inter_group_rows()
    b_fl, c_fl = h.hier.inter_group_rows_flat()
    log(f"  {what}: group-axis rows {h.comm.rows('g')} == "
        f"volume_rows_padded {h.stats()['volume_rows_padded']}; local-axis "
        f"rows {local}; slow-tier rows (B + C) {b_ig} + {c_ig} against the "
        f"flat plan's {b_fl} + {c_fl}")
    for be, c in out.items():
        log(f"  {what} {be}: max abs err vs scipy float64 "
            f"{check_c(c, a, b_host, f'{what} {be}'):.3g} (tol 2e-4)")
        if h.ex.meta.get("overlap_ready"):  # bucketed and overlapped
            staged = hier_spmm(h.ex, b, backend=be, overlap=False)
            if not torch.equal(staged, c):
                raise AssertionError(f"{what} {be}: staged C != "
                                     f"overlapped C")
            log(f"  {what} {be}: staged C bit-identical to overlapped C")
    if not torch.equal(hit, out[backends[0]]):
        raise AssertionError(f"{what}: two h(b) calls differ")
    if len(out) == 2:
        log(f"  {what}: coo vs bsr: "
            f"{check_close(out['coo'], _host64(out['bsr']), what)}")
    return launches


def hier_phase(args, a_u, a_p, adj, b, b_host, model, feats, gat_want,
               x128, y128):
    """Phase 5b: the three hier="auto" cells on the matrices of phases
    3-5. Returns (the kernel rows of the hier paths, the SpMM handles, the
    fused handle and its GAT layer function)."""
    from repro_torch import SpmmConfig, compile_fused, compile_spmm
    from repro_torch.core.dist_spmm import hier_spmm

    expect = EXPECT_HIER["quick" if args.quick else "full"]
    # per path: the recorded kernel calls, the launches of its counted run
    rec, counted, handles = {}, {}, []
    for name, a, path_of in (
            ("uniform", a_u, {"coo": "hier_uniform_coo",
                              "bsr": "hier_uniform"}),
            ("power_law", a_p, {"coo": "hier_power_law"})):
        t0 = time.perf_counter()
        h = compile_spmm(a, P, SpmmConfig(backends=tuple(path_of),
                                          hier="auto"))
        log(f"hier {name}: compile_spmm(hier='auto') "
            f"{time.perf_counter() - t0:.1f} s: {h}")
        check_decisions(h, *expect[name], f"hier {name}")
        # the executor calls h(b, backend=...) make, before the counted run
        for be, path in path_of.items():
            rec[path] = record_kernel_calls(
                lambda: hier_spmm(h.ex, b, backend=be, overlap=h.overlap))
        launches = check_hier_cell(h, a, b, b_host, f"hier {name}")
        counted.update({path: launches for path in path_of.values()})
        handles.append(h)

    # GAT on the hier fused handle, then the F = 128 SDDMM
    t0 = time.perf_counter()
    hf = compile_fused(adj, P, SpmmConfig(
        kernel="fused", edge="leaky_relu", backends=("coo", "bsr"),
        hier="auto"))
    log(f"hier GAT: compile_fused(hier='auto') "
        f"{time.perf_counter() - t0:.1f} s: {hf}")
    check_decisions(hf, *expect["gat"], "hier fused")
    fused_fn, gat_rec, gat_launches, _ = gat_cell(
        hf, model, feats, adj, b, gat_want, "hier GAT")
    for be, path in (("bsr", "hier_gat"), ("coo", "hier_gat_coo")):
        rec[path], counted[path] = gat_rec[be], gat_launches[be]
    rec["hier_sddmm_f128"], counted["hier_sddmm_f128"], _ = sddmm_cell(
        hf, adj, x128, y128, "hier sddmm")

    hu, hp = handles
    coo = ("gather_rows", "gather_rows_scaled", "scatter_add_rows")
    kernels_of = {
        "hier_uniform": ("gather_rows", "scatter_add_rows", "bsr_spmm")
        + (("bsr_spmm_acc",) if hu.overlap else ()),
        "hier_uniform_coo": coo, "hier_power_law": coo,
        "hier_gat": ("gather_rows", "scatter_add_rows", "bsr_spmm",
                     "bsr_sddmm"),
        "hier_gat_coo": coo,
        "hier_sddmm_f128": ("gather_rows", "bsr_sddmm"),
    }
    paths = {}
    for path, kernels in kernels_of.items():
        for k in kernels:
            paths.setdefault(k, {})[path] = (rec[path], counted[path])
    return replay_paths(paths), hu, hp, hf, fused_fn


def check_repl_cell(h, a, b, b_host, what: str):
    """Phase 5c's checks on one replicated SpMM handle: a counted run (h(b)
    per backend, then a cache hit), C against scipy float64, lane-axis
    rows == ``volume_rows_padded`` on every call (the replica
    reduce-scatter's rows and B's c-fold copy logged apart), call ==
    call, coo vs bsr within 2e-4. Returns the counted launches."""
    from repro_torch.kernels import ops

    backends = h.backends
    sched = h.schedule
    want_rows = sched.volume_rows_padded()

    def rows_of(op):
        return sum(r for o, _, r in h.comm.log if o == op)

    def lane_rows(label):
        if h.comm.rows("s") != want_rows:
            raise AssertionError(f"{label}: lane exchanges carried "
                                 f"{h.comm.rows('s')} rows, the schedule "
                                 f"says {want_rows}")

    ops.reset_launch_counts()
    out = {}
    for be in backends:
        out[be] = h(b, backend=be)
        lane_rows(f"{what} {be}")
    hit = h(b, backend=backends[0])
    lane_rows(f"{what} {backends[0]} (cache hit)")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"{what} main path launches: {json.dumps(launches)}")
    want = ["gather_rows", "gather_rows_scaled", "scatter_add_rows"]
    if "bsr" in backends:
        want.append("bsr_spmm")
    if min(launches[k] for k in want) < 1:
        raise AssertionError(f"{what}: a kernel was not launched "
                             f"({want}): {launches}")
    n_lane = sum(1 for o, _, _ in h.comm.log if o == "ppermute@s")
    log(f"  {what}: lane-axis rows {h.comm.rows('s')} == volume_rows_padded "
        f"{want_rows} over {n_lane} lane exchanges; replica reduce-scatter "
        f"rows {rows_of('psum_scatter@r')}; B's {sched.c}-fold copy rows "
        f"{rows_of('broadcast@r')}")
    for be, c in out.items():
        log(f"  {what} {be}: max abs err vs scipy float64 "
            f"{check_c(c, a, b_host, f'{what} {be}'):.3g} (tol 2e-4)")
    if not torch.equal(hit, out[backends[0]]):
        raise AssertionError(f"{what}: two h(b) calls differ")
    log(f"  {what} {backends[0]}: two h(b) calls bit-identical")
    if len(out) == 2:
        log(f"  {what}: coo vs bsr: "
            f"{check_close(out['coo'], _host64(out['bsr']), what)}")
    return launches


def repl_phase(args, a_u, a_p, b, b_host):
    """Phase 5c: the two replicate="auto" SpMM cells on the matrices of
    phases 3-4. Returns (the kernel rows of the replicated paths, the
    handles)."""
    from repro_torch import SpmmConfig, compile_spmm
    from repro_torch.core.dist_spmm import replicated_spmm

    expect = EXPECT_REPL["quick" if args.quick else "full"]
    rec, counted, handles = {}, {}, []
    for name, a, path_of in (
            ("uniform", a_u, {"coo": "repl_uniform_coo",
                              "bsr": "repl_uniform"}),
            ("power_law", a_p, {"coo": "repl_power_law"})):
        t0 = time.perf_counter()
        h = compile_spmm(a, P, SpmmConfig(backends=tuple(path_of),
                                          replicate="auto"))
        log(f"repl {name}: compile_spmm(replicate='auto') "
            f"{time.perf_counter() - t0:.1f} s: {h}")
        check_decisions(h, *expect[name], f"repl {name}")
        # the executor calls h(b, backend=...) make, before the counted run
        for be, path in path_of.items():
            rec[path] = record_kernel_calls(
                lambda: replicated_spmm(h.ex, b, backend=be))
        launches = check_repl_cell(h, a, b, b_host, f"repl {name}")
        counted.update({path: launches for path in path_of.values()})
        handles.append(h)

    coo = ("gather_rows", "gather_rows_scaled", "scatter_add_rows")
    kernels_of = {
        "repl_uniform": ("gather_rows", "scatter_add_rows", "bsr_spmm"),
        "repl_uniform_coo": coo, "repl_power_law": coo,
    }
    paths = {}
    for path, kernels in kernels_of.items():
        for k in kernels:
            paths.setdefault(k, {})[path] = (rec[path], counted[path])
    return replay_paths(paths), handles


# ---------------------------------------------------------------------------
# phase 5d: training through the backward compositions
# ---------------------------------------------------------------------------

GCN_DIMS = (128, 256, 256, 40)  # OGB's ogbn-arxiv GCN baseline widths
EPOCHS = {"gcn": 200, "gat": 50}  # the examples' defaults
QUICK_EPOCHS = {"gcn": 20, "gat": 12}
REPEAT_STEPS = 10
TRAIN_OPT = dict(lr=5e-3, weight_decay=0.0, warmup_steps=10)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)  # tests/test_sddmm.py's GAT grads
# aten ops no backward on the card may run: atomics and library calls for
# work a kernel of the port does
FORBIDDEN_OPS = ("index_add", "scatter_add", "scatter_reduce", "sparse")
PLAIN_VERSIONS = (("gather_rows", "gather_rows_plain"),
                  ("gather_rows", "gather_rows_scaled_plain"),
                  ("scatter_add_rows", "scatter_add_rows_plain"),
                  ("bsr_spmm", "bsr_spmm_plain"),
                  ("bsr_spmm", "bsr_spmm_acc_plain"),
                  ("sddmm", "bsr_sddmm_plain"),
                  ("rmsnorm", "rmsnorm_plain"),
                  ("rmsnorm", "rmsnorm_bwd_plain"))


class library_watch:
    """Within the block every aten op is named (a TorchDispatchMode, which
    the autograd engine carries into the backward's threads), under the
    ``stage`` it ran in, and every kernel's plain version raises.
    ``check`` then fails on an op of ``FORBIDDEN_OPS`` or an accumulating
    ``index_put``, and unless the watch saw ops of the backward stage."""

    def __enter__(self):
        import importlib

        from torch.utils._python_dispatch import TorchDispatchMode

        seen = self.seen = collections.Counter()
        self.stage = "forward"
        watch = self

        class Names(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = str(func)
                if name.startswith("aten.index_put") and (
                        kwargs.get("accumulate") or
                        (len(args) > 3 and args[3])):
                    name += " (accumulate)"
                seen[(watch.stage, name)] += 1
                return func(*args, **kwargs)

        def refuse(name):
            def plain(*args, **kwargs):
                raise AssertionError(f"{name} ran on the card")
            return plain

        self.saved = []
        for mod_name, attr in PLAIN_VERSIONS:
            mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
            self.saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, refuse(attr))
        self.mode = Names()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)

    def check(self, what: str) -> None:
        bad = sorted(n for n in self.seen
                     if any(f in n[1] for f in FORBIDDEN_OPS)
                     or n[1].endswith("(accumulate)"))
        if bad:
            raise AssertionError(f"{what}: the step ran {bad}")
        if not any(stage == "backward" for stage, _ in self.seen):
            raise AssertionError(f"{what}: the op watch saw no backward")


class Spmm64(torch.autograd.Function):
    """The float64 oracle's SpMM: A @ h, backward Aᵀ @ g (library CSR
    products; oracle only)."""

    @staticmethod
    def forward(ctx, a, at, h):
        ctx.at = at
        return a @ h

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.at @ g


def _csr64(a, dev, transpose: bool = False):
    import scipy.sparse as sp

    m = sp.csr_matrix((a.data.astype(np.float64), a.indices, a.indptr),
                      shape=a.shape)
    if transpose:
        m = m.T.tocsr()
    with warnings.catch_warnings():  # beta-state notices of torch.sparse
        warnings.simplefilter("ignore")
        return torch.sparse_csr_tensor(
            torch.from_numpy(m.indptr.astype(np.int64)),
            torch.from_numpy(m.indices.astype(np.int64)),
            torch.from_numpy(m.data), size=m.shape, device=dev)


def spmm64_fn(a, dev):
    """``h -> A h`` in float64 with its transpose as the backward."""
    fwd, bwd = _csr64(a, dev), _csr64(a, dev, transpose=True)
    return lambda h: Spmm64.apply(fwd, bwd, h)


def fused64_fn(a, dev):
    """``(q, k, v) -> leaky_relu(A ⊙ (q kᵀ)) @ v`` in float64 over the
    stored edges (library index ops; oracle only)."""
    import torch.nn.functional as F

    rows = torch.from_numpy(np.repeat(np.arange(a.shape[0]),
                                      np.diff(a.indptr))).to(dev)
    cols = torch.from_numpy(a.indices.astype(np.int64)).to(dev)
    w = torch.from_numpy(a.data.astype(np.float64)).to(dev)

    def fused(q, k, v):
        e = F.leaky_relu(w * (q[rows] * k[cols]).sum(-1), 0.2)
        return torch.zeros((a.shape[0], v.shape[1]), dtype=v.dtype,
                           device=v.device).index_add(0, rows,
                                                      e[:, None] * v[cols])
    return fused


def check_grads(got, want, what: str) -> float:
    """Each grad non-None and within GRAD_TOL of float64; returns the
    largest error over its tolerance (<= 1 passes)."""
    worst = 0.0
    for (name, g), w in zip(got, want):
        if g is None:
            raise AssertionError(f"{what}: no grad for {name}")
        g, w = _host64(g), _host64(w)
        np.testing.assert_allclose(g, w, err_msg=f"{what} {name}",
                                   **GRAD_TOL)
        worst = max(worst, float((np.abs(g - w) / (
            GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(w))).max()))
    return worst


def checked_step(forward, leaves, what: str):
    """One forward + backward, run twice from the same state: counted
    (launches by kernel and direction) inside ``library_watch``, then
    streamed through ``stream_kernel_calls`` (every kernel call checked
    and timed against its plain version). Both give the same grads bit
    for bit. Returns (loss, grads, forward launches, backward launches,
    {kernel: tally})."""
    from repro_torch.kernels import ops

    for p in leaves:
        p.grad = None
    ops.reset_launch_counts()
    with library_watch() as watch:
        loss = forward()
        torch.cuda.synchronize()
        fwd = ops.launch_counts()
        watch.stage = "backward"
        loss.backward()
        torch.cuda.synchronize()
    watch.check(what)
    total = ops.launch_counts()
    bwd = {k: total[k] - fwd[k] for k in total}
    grads = [p.grad for p in leaves]
    log(f"{what} launches a step, forward: {json.dumps(fwd)}; backward: "
        f"{json.dumps(bwd)}")
    for p in leaves:
        p.grad = None
    tallies, out = {}, []
    stream_kernel_calls(lambda: out.append(forward()), tallies=tallies)
    fwd_ms = {k: t.ms for k, t in tallies.items()}
    stream_kernel_calls(lambda: out[0].backward(), tallies=tallies)
    log(f"{what} kernel ms a step (replayed, CUDA events), forward / "
        f"backward: " + ", ".join(
            f"{k} {fwd_ms.get(k, 0.0):.4f} / {t.ms - fwd_ms.get(k, 0.0):.4f}"
            for k, t in tallies.items()))
    for p, g in zip(leaves, grads):
        if not torch.equal(p.grad, g):
            raise AssertionError(f"{what}: two steps' grads differ")
    for p, g in zip(leaves, grads):
        p.grad = g
    return loss.item(), grads, fwd, bwd, tallies


def step_rows(tallies, fwd, bwd, want_fwd, want_bwd, what: str) -> dict:
    """The path's kernel rows ({kernel: row}); every kernel of
    ``want_fwd`` launched in the forward, of ``want_bwd`` in the
    backward."""
    missing = [(k, d) for d, want, n in (("forward", want_fwd, fwd),
                                         ("backward", want_bwd, bwd))
               for k in want if n[k] < 1]
    if missing:
        raise AssertionError(f"{what}: not launched: {missing}")
    return {k: t.row(fwd[k] + bwd[k]) for k, t in tallies.items()}


def train(model, loss_fn, epochs: int):
    """AdamW (``TRAIN_OPT``, cosine over ``epochs``) for ``epochs``
    full-batch steps: CUDA events around each step's forward, backward and
    update, host wall per step (each step ends in a sync); the parameters
    after ``REPEAT_STEPS`` steps are kept."""
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_step

    params = list(model.parameters())
    cfg = AdamWConfig(total_steps=epochs, **TRAIN_OPT)
    state = adamw_init(params)
    out = {"fwd": [], "bwd": [], "upd": [], "wall": [], "loss": []}
    for ep in range(epochs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        loss = loss_fn(model)
        ev[1].record()
        loss.backward()
        ev[2].record()
        state, _ = adamw_step(cfg, params, state)
        ev[3].record()
        torch.cuda.synchronize()
        out["wall"].append((time.perf_counter() - t0) * 1e3)
        for key, (i, j) in (("fwd", (0, 1)), ("bwd", (1, 2)),
                            ("upd", (2, 3))):
            out[key].append(ev[i].elapsed_time(ev[j]))
        out["loss"].append(loss.item())
        if ep + 1 == REPEAT_STEPS:
            out["snapshot"] = [p.detach().clone() for p in params]
    return out


def train_cell(what: str, make_model, loss_fn, epochs: int, prep_s: float,
               card: str):
    """Train, then check and report: the loss falls, the first
    ``REPEAT_STEPS`` steps repeat bit for bit from a fresh start, and the
    per-epoch times, the prep ratio and the peak memory are printed."""
    torch.cuda.synchronize()
    t = train(make_model(), loss_fn, epochs)
    losses = t["loss"]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the loss did not fall: {losses[0]} "
                             f"-> {losses[-1]}")
    again = train(make_model(), loss_fn, REPEAT_STEPS)
    if not all(torch.equal(a, b) for a, b in zip(t["snapshot"],
                                                  again["snapshot"])):
        raise AssertionError(f"{what}: {REPEAT_STEPS} steps from the same "
                             f"start differ")
    med = {k: statistics.median(t[k]) for k in ("fwd", "bwd", "upd", "wall")}
    train_s = sum(t["wall"]) / 1e3
    log(f"{what} [{card}]: {epochs} epochs, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; per epoch (median) forward {med['fwd']:.3f} ms, "
        f"backward {med['bwd']:.3f} ms, AdamW {med['upd']:.3f} ms by CUDA "
        f"events, {med['wall']:.3f} ms host wall; training {train_s:.2f} s")
    log(f"  {what}: prep {prep_s:.2f} s, prep ratio (Tab. 3 protocol, "
        f"{epochs} epochs) {100 * prep_s / (prep_s + train_s):.1f}%; "
        f"{REPEAT_STEPS} steps repeated bit for bit; peak device memory "
        f"{peak_allocated() / 2 ** 30:.2f} GiB")
    return med


def _axes(h):
    return {"flat": ("x",), "hier": ("g", "l"),
            "replicated": ("s", "r")}[h.strategy]


def grad_check_handles(cells, b, b_host) -> None:
    """dB of ½‖h(b)‖² through each coo handle (``cells``: (handle, A,
    name)) against Aᵀ(A b) by scipy in float64 within the executor
    tolerance, 2e-4 + 2e-4·|A|ᵀ(|A| |b|): relative to the magnitude of
    the terms each float32 entry sums (on the power-law graph a hub's
    terms reach 1e4 while their sum may be near 0), inside
    ``library_watch``; the backward's rows == the forward's on each axis;
    a bsr call under grad refused."""
    import scipy.sparse as sp

    want = {}
    for h, a, what in cells:
        if id(a) not in want:
            m = sp.csr_matrix((a.data.astype(np.float64), a.indices,
                               a.indptr), shape=a.shape)
            b64 = b_host.astype(np.float64)
            want[id(a)] = (m.T @ (m @ b64),
                           abs(m).T @ (abs(m) @ np.abs(b64)))
        x = b.clone().requires_grad_()
        with library_watch() as watch:
            c = h(x)
            watch.stage = "backward"
            c.backward(c.detach())
            torch.cuda.synchronize()
        watch.check(what)
        ref, scale = want[id(a)]
        got = _host64(x.grad)
        ratio = np.abs(got - ref) / (2e-4 + 2e-4 * scale)
        if got.shape != ref.shape or not (ratio <= 1).all():
            raise AssertionError(f"{what} dB: max err / tol {ratio.max()}")
        err = (f"max abs err {np.abs(got - ref).max():.3g} at |Aᵀ(A b)| up "
               f"to {np.abs(ref).max():.3g}; max err / (2e-4 + 2e-4·"
               f"|A|ᵀ|A||b|) {ratio.max():.3g} (<= 1 passes)")
        rows = {ax: (h.comm.rows(ax), h.comm.rows(ax, "bwd"))
                for ax in _axes(h)}
        if any(f != r or f == 0 for f, r in rows.values()):
            raise AssertionError(f"{what}: forward / backward rows {rows}")
        if "bsr" in h.backends:
            try:
                h(x, backend="bsr")
            except NotImplementedError:
                pass
            else:
                raise AssertionError(f"{what}: a bsr call under grad ran")
        log(f"  grad {what}: dB of ½‖h(b)‖² vs scipy float64: {err}; "
            f"rows (forward, backward) {rows}"
            + ("; bsr under grad refused" if "bsr" in h.backends else ""))


def _check_step_rows(h, calls: int, what: str) -> None:
    """After a step of ``calls`` handle calls: the log holds the last
    call's forward and every call's backward; per axis the backward moved
    ``calls`` times the forward's rows."""
    rows = {ax: (h.comm.rows(ax), h.comm.rows(ax, "bwd")) for ax in _axes(h)}
    if any(r != calls * f or f == 0 for f, r in rows.values()):
        raise AssertionError(f"{what}: rows (forward, backward) {rows} for "
                             f"{calls} calls")
    log(f"  {what}: backward rows == {calls} calls × forward rows, per "
        f"axis (forward, backward) {rows}")


def train_phase(args, card, a_p, adj, cells, hf, gat_prep_s, b, b_host,
                gat_weights, dev: str = "cuda"):
    """Phase 5d: the grad checks on the SpMM handles (``cells``) and on
    the GAT handle's bsr SDDMM, then the GCN cell (normalize_adjacency of
    the power-law matrix) and the GAT cell (``hf``'s coo backend), each
    trained with AdamW. Returns {kernel: {path: row}} for the paths
    gcn_step, gat_step and gat_sddmm_grad."""
    import scipy.sparse as sp

    from repro_torch import compile_spmm
    from repro_torch.core import make_spmm_fn
    from repro_torch.models.gnn import (
        gat_from_numpy, gat_loss, gcn_from_numpy, gcn_loss, gcn_params,
        normalize_adjacency,
    )

    epochs = QUICK_EPOCHS if args.quick else EPOCHS
    grad_check_handles(cells, b, b_host)
    paths = {}

    # the GAT handle's bsr SDDMM under grad: K5's Function, K3 backward
    rng = np.random.default_rng(3)
    xs, ys = (torch.from_numpy(rng.standard_normal(
        (adj.shape[0], GAT_DIMS["att_dim"]), dtype=np.float32)).to(dev)
        .requires_grad_() for _ in range(2))
    _, grads, fwd, bwd, tallies = checked_step(
        lambda: 0.5 * sum(v.square().sum() for v in hf(
            xs, ys, kernel="sddmm", backend="bsr", edge=None).values()),
        [xs, ys], "gat_sddmm_grad")
    # the bsr layout stores a repeated (i, j) (a self-loop that
    # normalize_adjacency adds to a stored diagonal entry) as one value
    a64 = sp.csr_matrix((adj.data.astype(np.float64), adj.indices.copy(),
                         adj.indptr.copy()), shape=adj.shape)
    a64.sum_duplicates()  # in place: on copies of the graph's arrays
    rows = np.repeat(np.arange(adj.shape[0]), np.diff(a64.indptr))
    x64, y64 = _host64(xs), _host64(ys)
    s = sp.csr_matrix((a64.data ** 2 * np.einsum(
        "ef,ef->e", x64[rows], y64[a64.indices]), a64.indices, a64.indptr),
        shape=adj.shape)
    worst = check_grads([("X", grads[0]), ("Y", grads[1])],
                        [torch.from_numpy(s @ y64),
                         torch.from_numpy(s.T @ x64)], "gat_sddmm_grad")
    log(f"  gat_sddmm_grad: dX, dY of ½Σvals² (bsr, F = "
        f"{GAT_DIMS['att_dim']}) within rtol 2e-3 / atol 2e-4 of float64 "
        f"(max err / tol {worst:.3g})")
    paths["gat_sddmm_grad"] = step_rows(
        tallies, fwd, bwd, ("gather_rows", "bsr_sddmm"),
        ("scatter_add_rows", "bsr_spmm"), "gat_sddmm_grad")
    del xs, ys, grads, tallies, s

    # GCN: 128 -> 256 -> 256 -> 40 on normalize_adjacency(power-law)
    reset_peak()
    t0 = time.perf_counter()
    adj_g = normalize_adjacency(a_p)
    hg = compile_spmm(adj_g, P, device=dev)
    prep_s = time.perf_counter() - t0
    st = hg.stats()
    log(f"GCN graph: normalize_adjacency(power-law), nnz {adj_g.nnz}, "
        f"compile_spmm {prep_s:.1f} s: {hg}; volume rows "
        f"{st['volume_rows']} / {st['volume_rows_padded']} padded")
    weights = gcn_params(GCN_DIMS, seed=0)
    paths["gcn_step"], med_g = model_cell(
        "gcn-train-arxiv", hg, make_spmm_fn(hg), len(GCN_DIMS) - 1,
        lambda: gcn_from_numpy(weights, adj_g.shape[0], device=dev),
        gcn_loss, GCN_DIMS[0], GCN_DIMS[-1], spmm64_fn(adj_g, dev),
        epochs["gcn"], prep_s, card, dev, args.profile)
    del hg
    gc.collect()
    torch.cuda.empty_cache()

    # GAT: 128 -> 128 -> 40, att_dim 16, on the GAT graph's fused handle
    reset_peak()
    paths["gat_step"], med_a = model_cell(
        "gat-train-arxiv", hf, lambda q, k, v: hf(q, k, v, backend="coo"),
        GAT_DIMS["n_layers"],
        lambda: gat_from_numpy(gat_weights, adj.shape[0], device=dev),
        gat_loss, GAT_DIMS["feat_dim"], GAT_DIMS["n_classes"],
        fused64_fn(adj, dev), epochs["gat"], gat_prep_s, card, dev,
        args.profile)
    out = {}
    for path, per in paths.items():
        for k, row in per.items():
            out.setdefault(k, {})[path] = row
    return out, {"gcn": med_g, "gat": med_a}


def model_cell(what, handle, fn, calls, make_model, loss, feat_dim,
               n_classes, oracle_fn, epochs, prep_s, card, dev,
               profile=False):
    """One training cell: features N(0, 1) from numpy seed 1 and labels
    in [0, n_classes) from seed 2 on the handle's nodes; the first step
    through ``checked_step``, its grads against the float64 oracle
    (``oracle_fn`` in place of ``fn``), the backward's rows; then
    ``train_cell``; with ``profile``, a torch.profiler breakdown of one
    step. Returns ({kernel: row} of the step, median times)."""
    n = handle.plan.shape[0]
    feats = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (n, feat_dim), dtype=np.float32)).to(dev)
    labels = torch.from_numpy(np.random.default_rng(2).integers(
        0, n_classes, n)).to(dev)
    model = make_model()
    first, grads, fwd, bwd, tallies = checked_step(
        lambda: loss(model, feats, labels, fn), list(model.parameters()),
        what)
    _check_step_rows(handle, calls, what)
    oracle = make_model().double()
    loss64 = loss(oracle, feats.double(), labels, oracle_fn)
    loss64.backward()
    worst = check_grads(
        [(name, g) for (name, _), g in zip(model.named_parameters(), grads)],
        [p.grad for p in oracle.parameters()], what)
    log(f"  {what}: first-step loss {first:.6f} (float64 "
        f"{loss64.item():.6f}); every parameter's grad within rtol 2e-3 / "
        f"atol 2e-4 of float64 (max err / tol {worst:.3g})")
    coo = ("gather_rows", "gather_rows_scaled", "scatter_add_rows")
    rows = step_rows(tallies, fwd, bwd, coo, coo, what)
    if profile:
        profile_cells([(lambda: loss(model, feats, labels, fn).backward(),
                        f"{what} step (forward + backward)")])
    del model, oracle, grads, tallies, loss64
    gc.collect()
    med = train_cell(what, make_model,
                     lambda m: loss(m, feats, labels, fn), epochs, prep_s,
                     card)
    return rows, med


def median_ms(fn, reps: int = 7):
    """Median device time (CUDA events) and host time of one ``fn()``."""
    dev_ms, host_ms = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    return statistics.median(dev_ms), statistics.median(host_ms)


class comm_ranges:
    """Within the block, every ``LocalComm`` collective runs inside a
    profiler range named after it ("comm psum_scatter@l fold", "comm
    all_gather@l copy", ...), so a profile names the device time of the
    collectives' copies and of the reduce-scatter's additions."""

    NAMES = {"all_to_all": "comm all_to_all", "ppermute": None,
             "group_all_to_all": "comm all_to_all@g",
             "local_psum_scatter": "comm psum_scatter@l fold",
             "local_all_gather": "comm all_gather@l copy",
             "lane_shift": "comm ppermute@s lane",
             "replica_psum_scatter": "comm psum_scatter@r fold",
             "replicate": "comm broadcast@r copy"}

    def __enter__(self):
        from torch.profiler import record_function

        from repro_torch.distributed.comm import LocalComm

        self.saved = {k: getattr(LocalComm, k) for k in self.NAMES}

        def wrap(fn, name):
            def ranged(comm, *args, **kw):
                label = name or f"comm {kw.get('op', 'ppermute')}"
                with record_function(label):
                    return fn(comm, *args, **kw)
            return ranged

        for k, name in self.NAMES.items():
            setattr(LocalComm, k, wrap(self.saved[k], name))

    def __exit__(self, *exc):
        from repro_torch.distributed.comm import LocalComm

        for k, fn in self.saved.items():
            setattr(LocalComm, k, fn)


def profile_cells(cells) -> None:
    """torch.profiler over 3 calls per cell (``(fn, what)``, ``fn()`` one
    call): the kernels' device time as a share of the wall time (profiler
    overhead included), the kernels that take it, and the device time of
    each kind of collective (``comm_ranges``). Returns each cell's kernel
    names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for fn, what in cells:
        fn()
        torch.cuda.synchronize()
        with comm_ranges(), profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 3
        # the comm ranges also appear as device-side annotations: they
        # span kernels, they are not kernels
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not e.key.startswith("comm ")]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 3
        log(f"profile {what}: kernels busy {busy_ms:.3f} ms of "
            f"{wall_ms:.3f} ms wall per call (device idle "
            f"{100 - 100 * busy_ms / wall_ms:.1f}%)")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"    {e.self_device_time_total / 1e3 / 3:8.3f} ms  "
                f"{e.count // 3:4d}x  {e.key[:70]}")
        for e in prof.key_averages():
            if e.key.startswith("comm ") and e.device_type == DeviceType.CPU:
                log(f"    {e.device_time_total / 1e3 / 3:8.3f} ms  "
                    f"{e.count // 3:4d}x  {e.key} (device time of its "
                    f"kernels)")
        names[what] = [e.key for e in kernels]
    return names


# ---------------------------------------------------------------------------
# LM serving: OLMoE-1B-7B through the port's transformer and batcher
# ---------------------------------------------------------------------------


class plain_kernels:
    """Within the block, the K1 / K2 / K6 wrappers (K6's backward
    included) run their plain versions on the card: the float64 reference
    runs, which the kernels do not take."""

    NAMES = (("gather_rows", "gather_rows_cuda", "gather_rows_plain"),
             ("scatter_add_rows", "scatter_add_rows_cuda",
              "scatter_add_rows_plain"),
             ("rmsnorm", "rmsnorm_cuda", "rmsnorm_plain"),
             ("rmsnorm", "rmsnorm_bwd_cuda", "rmsnorm_bwd_plain"))

    def __enter__(self):
        import importlib

        self.saved = []
        for mod_name, cuda, plain in self.NAMES:
            mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
            self.saved.append((mod, cuda, getattr(mod, cuda)))
            setattr(mod, cuda, getattr(mod, plain))
        return self

    def __exit__(self, *exc):
        for mod, cuda, fn in self.saved:
            setattr(mod, cuda, fn)


def lm_requests(Request, vocab: int, seed: int = 0):
    """LM_SERVE's requests: prompts of 8-16 tokens from numpy ``seed``."""
    rng = np.random.default_rng(seed)
    lo, hi = LM_SERVE["prompt"]
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(n)).astype(
        np.int32), max_new_tokens=LM_SERVE["new_tokens"])
        for i, n in enumerate(rng.integers(lo, hi + 1, LM_SERVE["requests"]))]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def tensor_bytes(*trees) -> int:
    """The bytes of every tensor leaf of ``trees`` (dicts of tensors)."""
    return sum(t.numel() * t.element_size() for tree in trees
               for t in _leaves(tree) if isinstance(t, torch.Tensor))


# the steps phases 13 and 15 measure, which phase 16 holds the dry run
# against: {cell: dict(cfg, shape (launch.specs.ShapeSpec), placed (the
# bytes of the step's arguments on the card), peak (the peak bytes the
# step requests above its start, its arguments added), ms (the step's
# device time: CUDA events), how (which measured time))}
MEASURED = {}


def measure_step(cell, cfg, seq: int, batch: int, mode: str, run,
                 args_before: int):
    """``run()`` under ``launch.memory.executable_memory``, recorded in
    ``MEASURED[cell]``: ``run`` returns (its result, the step's device
    ms, how that time was taken, the bytes of the step's arguments on the
    card); ``args_before`` are the bytes of those arguments that existed
    before ``run`` (the rest it makes itself). Returns the result."""
    from repro_torch.launch.memory import executable_memory
    from repro_torch.launch.specs import ShapeSpec

    (out, ms, how, placed), mem = executable_memory(run, "cuda")
    MEASURED[cell] = dict(
        cfg=cfg, shape=ShapeSpec(cell, seq, batch, mode), placed=placed,
        peak=mem["total_allocation_size"] + args_before, ms=ms, how=how)
    return out


def check_finite(t: torch.Tensor, shape, what: str) -> None:
    if tuple(t.shape) != tuple(shape) or not bool(torch.isfinite(t).all()):
        raise AssertionError(f"{what}: shape {tuple(t.shape)} (want "
                             f"{tuple(shape)}) or non-finite values")


def lm_serving(args, card: str, dev: str = "cuda"):
    """Phase 7 on ``dev``. Returns (kernel paths for the JSON rows: K6's
    prefill, decode-step and float32-copy paths, and K1/K2's dispatch
    path; the model's config; its weights, which phase 10 serves
    again)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.dist_spmm import flat_spmm
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as TT
    from repro_torch.models.moe import compile_dispatch, dispatch_matrix
    from repro_torch.serving.scheduler import ContinuousBatcher, Request

    cfg = get_smoke_config(LM_ARCH) if args.quick else get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = TT.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"LM: {cfg.name} ({cfg.dtype}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_experts} experts top-"
        f"{cfg.top_k}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}): {n_params:,} "
        f"parameters, random (torch.Generator({dev!r}) seed 0), init "
        f"{time.perf_counter() - t0:.1f} s")
    per_step = 2 * cfg.n_layers + 1  # ln1 + ln2 per layer, final norm
    rng = np.random.default_rng(0)
    B, S = LM_PREFILL
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)}
    max_len = LM_SERVE["max_len"]

    # the K6 calls of one prefill and one decode step, before the counted runs
    pre_calls = record_kernel_calls(
        lambda: TT.forward(params, cfg, None, batch))
    cache = TT.init_decode_cache(cfg, B, max_len, device=dev)
    first = batch["tokens"][:, :1]
    dec_calls = record_kernel_calls(
        lambda: TT.decode_step(params, cfg, None, first, cache))

    ops.reset_launch_counts()
    logits = TT.forward(params, cfg, None, batch)
    torch.cuda.synchronize()
    pre_launches = ops.launch_counts()
    check_finite(logits, (B, S, cfg.vocab_size), "prefill logits")
    cache = TT.init_decode_cache(cfg, B, max_len, device=dev)
    ops.reset_launch_counts()
    step_logits, _ = TT.decode_step(params, cfg, None, first, cache)
    torch.cuda.synchronize()
    dec_launches = ops.launch_counts()
    check_finite(step_logits, (B, 1, cfg.vocab_size), "decode-step logits")
    log(f"prefill {B}x{S} launches: {json.dumps(pre_launches)}; one decode "
        f"step (B={B}): {json.dumps(dec_launches)}")
    for what, n in (("prefill", pre_launches), ("decode step", dec_launches)):
        if n["rmsnorm"] != per_step or sum(n.values()) != per_step:
            raise AssertionError(f"{what}: K6 launched {n['rmsnorm']} times "
                                 f"(want 2·{cfg.n_layers} + 1 = {per_step}) "
                                 f"or another kernel ran: {n}")

    # the batcher: 12 requests through 8 slots, twice
    def serve():
        reqs = lm_requests(Request, cfg.vocab_size)
        batcher = ContinuousBatcher(cfg, params, LM_SERVE["max_batch"],
                                    max_len)
        for r in reqs:
            batcher.submit(r)
        torch.cuda.synchronize()
        t = time.perf_counter()
        stats = batcher.run()
        torch.cuda.synchronize()
        return reqs, stats, time.perf_counter() - t

    ops.reset_launch_counts()
    reqs, stats, wall = serve()
    serve_launches = ops.launch_counts()
    want_tokens = LM_SERVE["requests"] * LM_SERVE["new_tokens"]
    log(f"batcher: served {stats.served}, generated {stats.generated_tokens} "
        f"tokens in {stats.decode_steps} decode steps, mean occupancy "
        f"{stats.mean_occupancy:.4f}, launches {json.dumps(serve_launches)}")
    if stats.served != LM_SERVE["requests"] or \
            stats.generated_tokens != want_tokens:
        raise AssertionError(f"batcher served {stats.served} requests and "
                             f"{stats.generated_tokens} tokens (want "
                             f"{LM_SERVE['requests']} and {want_tokens})")
    if serve_launches["rmsnorm"] != per_step * stats.decode_steps:
        raise AssertionError(f"batcher: K6 launched "
                             f"{serve_launches['rmsnorm']} times over "
                             f"{stats.decode_steps} steps")
    reqs2, stats2, wall2 = serve()
    if [r.output for r in reqs2] != [r.output for r in reqs]:
        raise AssertionError("batcher: a second run gave other tokens")
    log(f"batcher: a second run gave identical outputs; generated tokens per "
        f"second [{card}]: {want_tokens / wall:.1f} and "
        f"{want_tokens / wall2:.1f} (host wall {wall:.3f} s and "
        f"{wall2:.3f} s, prompts fed token by token)")
    for fn, what in ((lambda: TT.forward(params, cfg, None, batch),
                      f"prefill {B}x{S}"),
                     (lambda: TT.decode_step(params, cfg, None, first, cache),
                      f"decode step B={B}")):
        dev_ms, host_ms = median_ms(fn)
        log(f"{what} [{card}]: median of 7: {dev_ms:.3f} ms device events, "
            f"{host_ms:.3f} ms host wall")
    if args.profile:
        profile_cells([
            (lambda: TT.forward(params, cfg, None, batch), f"prefill {B}x{S}"),
            (lambda: TT.decode_step(params, cfg, None, first, cache),
             f"decode step B={B}")])

    # a float32 copy of the first layers: decode == forward, both == float64
    n_l = min(LM_F32["n_layers"], cfg.n_layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=n_l)
    p32 = {k: v for k, v in params.items() if k != "layers"}
    p32["layers"] = TT._tree_map(lambda t: t[:n_l], params["layers"])
    p32 = TT._tree_map(lambda t: t.float(), p32)
    del logits, cache
    gc.collect()
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        LM_F32["batch"], LM_F32["tokens"])).astype(np.int32)).to(dev)
    f32_calls = record_kernel_calls(
        lambda: TT.forward(p32, cfg32, None, {"tokens": toks}))
    ops.reset_launch_counts()
    fwd32 = TT.forward(p32, cfg32, None, {"tokens": toks})
    torch.cuda.synchronize()
    f32_launches = ops.launch_counts()["rmsnorm"]
    if f32_launches != 2 * n_l + 1:
        raise AssertionError(f"float32 copy: K6 launched {f32_launches} times")
    cache32 = TT.init_decode_cache(cfg32, toks.shape[0], toks.shape[1],
                                  device=dev)
    steps = []
    for j in range(toks.shape[1]):
        out, cache32 = TT.decode_step(p32, cfg32, None, toks[:, j:j + 1],
                                      cache32)
        steps.append(out)
    dec32 = torch.cat(steps, dim=1)
    check_finite(fwd32, (*toks.shape, cfg.vocab_size), "float32 logits")
    cfg64 = dataclasses.replace(cfg32, dtype="float64")
    p64 = TT._tree_map(lambda t: t.double(), p32)
    with plain_kernels():
        fwd64 = TT.forward(p64, cfg64, None, {"tokens": toks})
    want = _host64(fwd64)
    log(f"float32 copy ({n_l} layers, {toks.shape[0]}x{toks.shape[1]} "
        f"tokens): decode_step vs forward: "
        f"{check_close(dec32, _host64(fwd32), 'decode vs forward')}")
    log(f"  forward vs the float64 plain run: "
        f"{check_close(fwd32, want, 'forward vs float64')}")
    log(f"  decode_step vs the float64 plain run: "
        f"{check_close(dec32, want, 'decode vs float64')}")
    del p32, p64, fwd64, cache32
    gc.collect()

    # the SHIRO dispatch of one prefill's tokens at the model's width
    t0 = time.perf_counter()
    hd = compile_dispatch(cfg, DISPATCH["tokens"], DISPATCH["M"], device=dev)
    log(f"dispatch: compile_dispatch({cfg.name}, tokens="
        f"{DISPATCH['tokens']}, M={DISPATCH['M']}) "
        f"{time.perf_counter() - t0:.2f} s: {hd}")
    if not args.quick:
        check_decisions(hd, EXPECT_DISPATCH, {}, "dispatch")
    x = torch.from_numpy(rng.standard_normal(
        (DISPATCH["tokens"], cfg.d_model), dtype=np.float32)).to(dev)
    disp_calls = record_kernel_calls(
        lambda: flat_spmm(hd.ex, x, backend="coo", overlap=hd.overlap))
    ops.reset_launch_counts()
    c = hd(x)
    torch.cuda.synchronize()
    disp_launches = ops.launch_counts()
    log(f"dispatch launches: {json.dumps(disp_launches)}")
    if min(disp_launches[k] for k in ("gather_rows", "gather_rows_scaled",
                                      "scatter_add_rows")) < 1:
        raise AssertionError(f"dispatch: K1/K2 not launched: {disp_launches}")
    check_rows(hd, "dispatch")
    a = dispatch_matrix(cfg, DISPATCH["tokens"], DISPATCH["M"])
    dense = torch.zeros(a.shape, dtype=torch.float64, device=dev)
    rows_ = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    dense[torch.from_numpy(rows_).to(dev), torch.from_numpy(
        a.indices.astype(np.int64)).to(dev)] = torch.from_numpy(
        a.data.astype(np.float64)).to(dev)
    log(f"  dispatch C {list(c.shape)} vs the dense dispatch in float64: "
        f"{check_close(c, _host64(dense @ x.double()), 'dispatch C')}")

    return {
        "rmsnorm": {"prefill": kernel_row("rmsnorm", pre_calls["rmsnorm"],
                                          pre_launches["rmsnorm"]),
                    "decode_step": kernel_row("rmsnorm", dec_calls["rmsnorm"],
                                              dec_launches["rmsnorm"]),
                    "f32_copy": kernel_row("rmsnorm", f32_calls["rmsnorm"],
                                           f32_launches)},
        "gather_rows": {"dispatch": kernel_row(
            "gather_rows", disp_calls["gather_rows"],
            disp_launches["gather_rows"])},
        "gather_rows_scaled": {"dispatch": kernel_row(
            "gather_rows_scaled", disp_calls["gather_rows_scaled"],
            disp_launches["gather_rows_scaled"])},
        "scatter_add_rows": {"dispatch": kernel_row(
            "scatter_add_rows", disp_calls["scatter_add_rows"],
            disp_launches["scatter_add_rows"])},
    }, cfg, params


# ---------------------------------------------------------------------------
# phase 10: the expert-parallel LM on an emulated (data, model) grid
# ---------------------------------------------------------------------------

EP_GRID = ((2, 4), ("data", "model"))  # the reference's moe_serve mesh
EP_DISPATCH_DRIFT = 1  # the seed of the routing snapshot maybe_replan takes
# the reference's dispatch_session(get_config("olmoe-1b-7b"), 1024, 8):
# its first rung's decisions are EXPECT_DISPATCH; maybe_replan(
# dispatch_matrix(cfg, 1024, 8, seed=1)) returns (1.0, True) (the slot
# count moved: the pattern's shape changed) and swaps to these (JAX
# package, CPU run)
EXPECT_SESSION_REPLAN = (1.0, True)
EXPECT_SESSION_DRIFTED = dict(
    EXPECT_DISPATCH, shape=(8488, 1024),
    modeled_time_schedule=5.2972799999999995e-05, volume_rows=4853,
    volume_rows_padded=6440, volume_rows_padded_single=7360)


def _dropped(rec) -> list:
    return [int(r["dropped"]) for r in rec]


def ep_phase(args, card: str, cfg, params, dev: str = "cuda") -> dict:
    """Phase 10: phase 7's model through the expert-parallel MoE path
    (``_moe_ep``) on an emulated (data 2, model 4) grid. Returns kernel
    paths for the JSON rows: K1 / K2 / K6 on the EP prefill and decode
    step, K1 / K2 on ``dispatch_session``'s handle."""
    from repro_torch.core.dist_spmm import flat_spmm
    from repro_torch.distributed.context import make_context
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as TM
    from repro_torch.models import transformer as TT
    from repro_torch.serving.scheduler import ContinuousBatcher, Request

    t_phase = time.perf_counter()
    dist = make_context(make_mesh(*EP_GRID))
    M, dsz = dist.model_size, dist.batch_size_divisor
    e_loc = cfg.n_experts // M
    log(f"EP: {cfg.name} on the grid {dict(dist.mesh.shape)} (batch axes "
        f"{dist.batch_axes}), {e_loc} experts a model rank, capacity_factor "
        f"{cfg.capacity_factor}, shiro_dispatch {cfg.shiro_dispatch}, "
        f"shiro_capacity {cfg.shiro_capacity}")
    rng = np.random.default_rng(0)
    B, S = LM_PREFILL
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)}
    max_len = LM_SERVE["max_len"]
    first = batch["tokens"][:, :1]
    per_step = 2 * cfg.n_layers + 1
    # a MoE layer: K1 packs the dispatch buffer and gathers every local
    # expert's rows, K2 folds the combine and the return
    want_launch = {"gather_rows": 2 * cfg.n_layers,
                   "scatter_add_rows": 2 * cfg.n_layers, "rmsnorm": per_step}

    # every kernel call of one EP prefill and one EP decode step, checked
    # against its plain version and timed as it happens (the prefill's
    # calls at full width would not fit on the card all at once)
    pre_tally = stream_kernel_calls(
        lambda: TT.forward(params, cfg, dist, batch))
    cache = TT.init_decode_cache(cfg, B, max_len, device=dev)
    dec_tally = stream_kernel_calls(
        lambda: TT.decode_step(params, cfg, dist, first, cache))

    # the main path, counted: one prefill, one decode step
    dist.comm.reset()
    ops.reset_launch_counts()
    with TM.record_dispatch() as rec:
        logits = TT.forward(params, cfg, dist, batch)
    torch.cuda.synchronize()
    pre_launches = ops.launch_counts()
    check_finite(logits, (B, S, cfg.vocab_size), "EP prefill logits")
    caps = {(r["cap"], r["cap_e"]) for r in rec}
    if len(caps) != 1 or len(rec) != cfg.n_layers:
        raise AssertionError(f"EP prefill: {len(rec)} MoE calls, "
                             f"capacities {caps}")
    (cap, cap_e), = caps
    acts = [n for op, _, n in dist.comm.log if op == "all_to_all@model"]
    if acts != [dsz * M * M * cap] * (2 * cfg.n_layers):
        raise AssertionError(f"EP prefill: activation rows {acts[:4]}... "
                             f"(want {2 * cfg.n_layers} x Dsz·M·M·cap = "
                             f"{dsz * M * M * cap})")
    log(f"EP prefill {B}x{S}: cap {cap}, cap_e {cap_e}; model-axis "
        f"activation rows {dist.comm.rows('model')} = {2 * cfg.n_layers} "
        f"exchanges x Dsz·M·M·cap ({dsz}·{M}·{M}·{cap}); index / gate rows "
        f"{dist.comm.rows('model:meta')}; dispatch rows filled per layer "
        f"{[int(r['sent']) for r in rec]}; dropped assignments per layer "
        f"{_dropped(rec)} of {B * S * cfg.top_k}")
    cache = TT.init_decode_cache(cfg, B, max_len, device=dev)
    ops.reset_launch_counts()
    step_logits, _ = TT.decode_step(params, cfg, dist, first, cache)
    torch.cuda.synchronize()
    dec_launches = ops.launch_counts()
    check_finite(step_logits, (B, 1, cfg.vocab_size), "EP decode logits")
    log(f"EP launches: prefill {json.dumps(pre_launches)}; one decode step "
        f"(B={B}) {json.dumps(dec_launches)}")
    for what, n in (("prefill", pre_launches), ("decode step", dec_launches)):
        if {k: n[k] for k in want_launch} != want_launch or \
                sum(n.values()) != sum(want_launch.values()):
            raise AssertionError(f"EP {what}: launches {n}, want "
                                 f"{want_launch}")

    # the batcher under the grid: phase 7's 12 requests, twice
    def serve():
        reqs = lm_requests(Request, cfg.vocab_size)
        batcher = ContinuousBatcher(cfg, params, LM_SERVE["max_batch"],
                                    max_len, dist=dist)
        for r in reqs:
            batcher.submit(r)
        torch.cuda.synchronize()
        t = time.perf_counter()
        stats = batcher.run()
        torch.cuda.synchronize()
        return reqs, stats, time.perf_counter() - t

    ops.reset_launch_counts()
    reqs, stats, wall = serve()
    serve_launches = ops.launch_counts()
    want_tokens = LM_SERVE["requests"] * LM_SERVE["new_tokens"]
    if stats.served != LM_SERVE["requests"] or \
            stats.generated_tokens != want_tokens:
        raise AssertionError(f"EP batcher served {stats.served} requests and "
                             f"{stats.generated_tokens} tokens")
    if any(serve_launches[k] != n * stats.decode_steps
           for k, n in want_launch.items()):
        raise AssertionError(f"EP batcher: launches {serve_launches} over "
                             f"{stats.decode_steps} steps")
    reqs2, _, wall2 = serve()
    if [r.output for r in reqs2] != [r.output for r in reqs]:
        raise AssertionError("EP batcher: a second run gave other tokens")
    log(f"EP batcher: served {stats.served}, {stats.generated_tokens} tokens "
        f"in {stats.decode_steps} steps, launches "
        f"{json.dumps(serve_launches)}; a second run gave identical outputs")
    log(f"EP batcher tokens per second [{card}]: {want_tokens / wall:.1f} "
        f"and {want_tokens / wall2:.1f} (host wall {wall:.3f} s, "
        f"{wall2:.3f} s; phase 7 gives the dense path's)")
    for fn, what in (
            (lambda: TT.forward(params, cfg, dist, batch),
             f"EP prefill {B}x{S}"),
            (lambda: TT.forward(params, cfg, None, batch),
             f"dense prefill {B}x{S}"),
            (lambda: TT.decode_step(params, cfg, dist, first, cache),
             f"EP decode step B={B}"),
            (lambda: TT.decode_step(params, cfg, None, first, cache),
             f"dense decode step B={B}")):
        dev_ms, host_ms = median_ms(fn)
        log(f"{what} [{card}]: median of 7: {dev_ms:.3f} ms device events, "
            f"{host_ms:.3f} ms host wall")
    if args.profile:
        profile_cells([
            (lambda: TT.forward(params, cfg, dist, batch),
             f"EP prefill {B}x{S}"),
            (lambda: TT.decode_step(params, cfg, dist, first, cache),
             f"EP decode step B={B}")])
    del logits, step_logits, cache

    # a float32 copy of the first layers: EP against dense, shiro against
    # classic, decode against forward, the card against the CPU
    n_l = min(LM_F32["n_layers"], cfg.n_layers)
    p32 = {k: v for k, v in params.items() if k != "layers"}
    p32["layers"] = TT._tree_map(lambda t: t[:n_l], params["layers"])
    p32 = TT._tree_map(lambda t: t.float(), p32)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        LM_F32["batch"], LM_F32["tokens"])).astype(np.int32)).to(dev)
    f32 = {"tokens": toks}

    def copy(**kw):
        return dataclasses.replace(cfg, dtype="float32", n_layers=n_l, **kw)

    wide = copy(capacity_factor=8.0)  # no assignment dropped
    with TM.record_dispatch() as rec_s:
        ep = TT.forward(p32, wide, dist, f32)
    with TM.record_dispatch() as rec_c:
        classic = TT.forward(p32, dataclasses.replace(
            wide, shiro_dispatch=False), dist, f32)
    if any(_dropped(rec_s) + _dropped(rec_c)):
        raise AssertionError(f"capacity 8.0 dropped: {_dropped(rec_s)} "
                             f"{_dropped(rec_c)}")
    dense = TT.forward(p32, wide, None, f32)
    log(f"float32 copy ({n_l} layers, {tuple(toks.shape)} tokens), "
        f"capacity 8.0: EP vs dense: "
        f"{check_close(ep, _host64(dense), 'EP vs dense')}")
    log(f"  shiro vs classic: "
        f"{check_close(ep, _host64(classic), 'shiro vs classic')}")
    sent = [(int(a["sent"]), int(b["sent"])) for a, b in zip(rec_s, rec_c)]
    if not all(s < c for s, c in sent):
        raise AssertionError(f"the dedup sent no fewer rows: {sent}")
    log(f"  dispatch rows filled per layer, shiro vs classic (the same "
        f"routing): {sent}")
    if not torch.equal(TT.forward(p32, wide, dist, f32), ep):
        raise AssertionError("EP forward: a repeat differs")
    steps = {}
    for shard_kv in (False, True):
        c32 = dataclasses.replace(wide, kv_seq_shard=shard_kv)
        cache32 = TT.init_decode_cache(c32, toks.shape[0], toks.shape[1],
                                       device=dev)
        outs = []
        for j in range(toks.shape[1]):
            out, cache32 = TT.decode_step(p32, c32, dist, toks[:, j:j + 1],
                                          cache32)
            outs.append(out)
        steps[shard_kv] = torch.cat(outs, dim=1)
    log(f"  EP decode_step vs forward: "
        f"{check_close(steps[False], _host64(ep), 'EP decode vs forward')}")
    log(f"  kv_seq_shard decode vs unsharded decode: "
        f"{check_close(steps[True], _host64(steps[False]), 'seq-shard')}")
    # the M model ranks of one MoE layer, on its own input
    lp = TT._layer(p32["layers"], 0)["moe"]
    x = torch.randn((LM_F32["batch"], LM_F32["tokens"], cfg.d_model),
                    generator=torch.Generator(dev).manual_seed(1),
                    device=dev)
    ranks = TM._moe_ep(lp, x, wide, dist, True, all_ranks=True)
    if not all(torch.equal(ranks[m], ranks[0]) for m in range(1, M)):
        raise AssertionError("EP: the model ranks' outputs differ")
    log(f"  the {M} model ranks' outputs are bit-identical; a repeated "
        f"forward is bit-identical")
    # at the published capacity: the card against the port's CPU run
    pub = copy()
    with TM.record_dispatch() as rec_g:
        got = TT.forward(p32, pub, dist, f32)
    p_cpu = TT._tree_map(lambda t: t.cpu(), p32)
    with TM.record_dispatch() as rec_h:
        want = TT.forward(p_cpu, pub, dist, {"tokens": toks.cpu()})
    if _dropped(rec_g) != _dropped(rec_h):
        raise AssertionError(f"drops: card {_dropped(rec_g)}, CPU "
                             f"{_dropped(rec_h)}")
    log(f"  capacity {cfg.capacity_factor}: dropped per layer "
        f"{_dropped(rec_g)} on the card and on the CPU; card vs CPU: "
        f"{check_close(got, _host64(want), 'EP card vs CPU')}")
    del p32, p_cpu, ep, classic, dense, got, want, steps, ranks
    gc.collect()

    # the drift-aware dispatch session over one prefill's routing
    t0 = time.perf_counter()
    sess = TM.dispatch_session(cfg, DISPATCH["tokens"], DISPATCH["M"],
                               device=dev)
    hd = sess.handle()
    log(f"dispatch_session({cfg.name}, {DISPATCH['tokens']}, "
        f"{DISPATCH['M']}) {time.perf_counter() - t0:.2f} s: {hd}")
    if not args.quick:
        check_decisions(hd, EXPECT_DISPATCH, {}, "dispatch_session")
    xd = torch.from_numpy(rng.standard_normal(
        (DISPATCH["tokens"], cfg.d_model), dtype=np.float32)).to(dev)
    ds_calls = record_kernel_calls(
        lambda: flat_spmm(hd.ex, xd, backend="coo", overlap=hd.overlap))
    ops.reset_launch_counts()
    c = hd(xd)
    torch.cuda.synchronize()
    ds_launches = ops.launch_counts()
    if min(ds_launches[k] for k in ("gather_rows", "gather_rows_scaled",
                                    "scatter_add_rows")) < 1:
        raise AssertionError(f"dispatch_session: K1/K2 not launched: "
                             f"{ds_launches}")
    check_rows(hd, "dispatch_session")
    for seed in (0, EP_DISPATCH_DRIFT):
        a = TM.dispatch_matrix(cfg, DISPATCH["tokens"], DISPATCH["M"],
                               seed=seed)
        if seed:
            got = sess.maybe_replan(a)
            log(f"  maybe_replan(dispatch_matrix(seed={seed})): {got}")
            if not args.quick and got != EXPECT_SESSION_REPLAN:
                raise AssertionError(f"maybe_replan gave {got}, the "
                                     f"reference {EXPECT_SESSION_REPLAN}")
            if not args.quick:
                check_decisions(sess.handle(), EXPECT_SESSION_DRIFTED, {},
                                "dispatch_session (replanned)")
            c = sess.handle()(xd)
        dense = torch.zeros(a.shape, dtype=torch.float64, device=dev)
        rows_ = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
        dense[torch.from_numpy(rows_).to(dev), torch.from_numpy(
            a.indices.astype(np.int64)).to(dev)] = 1.0
        log(f"  session C (routing seed {seed}) vs the dense dispatch in "
            f"float64: {check_close(c, _host64(dense @ xd.double()), 'C')}")
    log(f"phase 10 EP: {time.perf_counter() - t_phase:.1f} s")

    paths = {}
    for k in ("gather_rows", "scatter_add_rows", "rmsnorm"):
        paths[k] = {"ep_prefill": pre_tally[k].row(pre_launches[k], False),
                    "ep_decode": dec_tally[k].row(dec_launches[k], False)}
    for k in ("gather_rows", "gather_rows_scaled", "scatter_add_rows"):
        paths.setdefault(k, {})["dispatch_session"] = kernel_row(
            k, ds_calls[k], ds_launches[k])
    return paths


# ---------------------------------------------------------------------------
# phase 8: the lifecycle — measured autotuning, the cache, memory and
# donation, the session ladder, drift, the bundle, faults
# ---------------------------------------------------------------------------


class autotune_watch:
    """Record, while active, every candidate ``core.autotune`` times (its
    info and measured seconds) and the model-only decision each measured
    overlay starts from (tier, schedule kind, K, overlap, modeled time)."""

    def __enter__(self):
        from repro_torch.core import autotune

        self.mod, self.timed, self.model = autotune, [], []
        self._profile = autotune.profile_candidate
        self._decide = autotune.measured_decide

        def profile(handle, b, backend, *, warmup, iters, info):
            t = self._profile(handle, b, backend, warmup=warmup, iters=iters,
                              info=info)
            self.timed.append(dict(info, measured_time=t))
            return t

        def decide(a, P_, config, topo, *, plan, hier, hier_cand, schedule,
                   decisions):
            self.model.append(dict(
                tier="hier" if hier is not None else "flat",
                kind=schedule.kind,
                K=schedule.K if schedule.kind == "bucketed" else None,
                overlap=decisions["overlap"],
                model_time=autotune.decision_modeled_time(decisions)))
            return self._decide(a, P_, config, topo, plan=plan, hier=hier,
                                hier_cand=hier_cand, schedule=schedule,
                                decisions=decisions)

        autotune.profile_candidate, autotune.measured_decide = profile, decide
        return self

    def __exit__(self, *exc):
        self.mod.profile_candidate = self._profile
        self.mod.measured_decide = self._decide


def rewire(a, frac: float, seed: int):
    """``a`` with ``frac`` of its nonzeros moved to random columns of their
    rows (duplicates summed): a pattern drift of about 2·frac / (1 + frac)
    in Jaccard distance."""
    from repro_torch.core.sparse import COOMatrix, csr_from_coo

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int32),
                     np.diff(a.indptr))
    cols = a.indices.copy()
    moved = rng.choice(a.nnz, int(frac * a.nnz), replace=False)
    cols[moved] = rng.integers(0, a.shape[1], moved.size, dtype=np.int32)
    return csr_from_coo(COOMatrix(a.shape, rows, cols, a.data.copy()))


def _winner(h) -> dict:
    d = h.decisions
    return dict(tier=h.strategy, kind=h.schedule.kind,
                K=h.schedule.K if h.schedule.kind == "bucketed" else None,
                overlap=h.overlap, backend=h.default_backend,
                measured_ms=None if d.get("measured_time") is None
                else 1e3 * d["measured_time"])


# tests/test_torch_cuda.py's donation cases at their sizes: (matrix,
# config, width of B); phase 8 measures them beside the uniform cell
DONATION_CASES = {
    "reference": (lambda sp: sp.power_law_sparse(64, 64, 400, 1.2, seed=2),
                  dict(backends=("coo",), schedule=4, overlap=False,
                       n_dense_hint=16), 16),
    "power-law-staged": (
        lambda sp: sp.power_law_sparse(4096, 4096, 40000, 1.2, seed=3),
        dict(schedule=2, overlap=False), 128),
    "hier": (lambda sp: sp.power_law_sparse(4096, 4096, 40000, 1.2, seed=3),
             dict(hier=(2, 4), schedule=1, overlap=True), 128),
}


def first_call_peak(h, b_host: np.ndarray):
    """``h(b_host)`` (a memo key's first call) under the allocator's
    history: (C, the frames of ``repro_torch`` innermost first at the
    moment the call's live bytes peak)."""
    mem = torch.cuda.memory
    torch.cuda.synchronize()
    mem._record_memory_history(max_entries=1_000_000, stacks="python")
    try:
        c = h(b_host)
        torch.cuda.synchronize()
        snap = mem._snapshot()
    finally:
        mem._record_memory_history(enabled=None)
    live = peak = 0
    at = None
    mine = set()  # blocks the call allocated: frees of older ones (garbage
    # the handle's measurement collects first) do not count
    for ev in snap["device_traces"][torch.cuda.current_device()]:
        if ev["action"] == "alloc":
            mine.add(ev["addr"])
            live += ev["size"]
            if live > peak:
                peak, at = live, ev
        elif ev["action"] == "free_completed" and ev["addr"] in mine:
            mine.discard(ev["addr"])
            live -= ev["size"]
    frames = [f"{f['name']}:{f['line']}" for f in (at or {}).get(
        "frames", []) if "repro_torch" in f["filename"]]
    return c, " < ".join(frames[:6]) or "unknown"


def donation_case(a, cfg: dict, b_host: np.ndarray) -> dict:
    """The first call's ``total_allocation_size`` with and without
    donation on a host B (the handle's private copy), where each call's
    peak falls, and the checks: C bit-identical, a caller's CUDA B never
    written."""
    from repro_torch import SpmmConfig, compile_spmm
    from repro_torch.core.api import materialize_payload

    hd = compile_spmm(a, P, SpmmConfig(measure=False, **cfg))
    payload = hd.save_payload()
    payload["config"] = dataclasses.replace(hd.config, donate=False)
    hu = materialize_payload(payload, P)
    cd, at_d = first_call_peak(hd, b_host)
    cu, at_u = first_call_peak(hu, b_host)
    if hd.stats()["donated_buffers"] != ("b",) or not torch.equal(cd, cu):
        raise AssertionError("donation changed C")
    b = torch.from_numpy(b_host).cuda()
    keep = b.clone()
    if not (torch.equal(hd(b), cd) and torch.equal(b, keep)):
        raise AssertionError("donation: the caller's B was changed")
    return dict(handle=str(hd), donated=hd.stats()["total_allocation_size"],
                **{"not": hu.stats()["total_allocation_size"]},
                peak_donated=at_d, peak_not=at_u, c=cd)


# phase 8 runs on a quarter of the arxiv cell: nodes and edges / 4, the
# same generators and seeds (cut to keep the script in its time limit;
# every measured candidate is planned and prepared on the host)
LIFE_SCALE = 4


def life_matrices(args):
    """The uniform and power-law matrices of phase 8 and their B (host),
    at 1 / LIFE_SCALE of phases 3-4's size."""
    from repro_torch.core.sparse import power_law_sparse, random_sparse

    m = (16_384 if args.quick else M_FULL) // LIFE_SCALE
    nnz = (7 * 16_384 if args.quick else NNZ_FULL) // LIFE_SCALE
    b_host = np.random.default_rng(0).standard_normal(
        (m, N_COLS), dtype=np.float32)
    return (random_sparse(m, m, nnz / m ** 2, seed=0),
            power_law_sparse(m, m, nnz, 0.8, seed=0), b_host)


def lifecycle_phase(args, card) -> dict:
    """Phase 8: the session lifecycle on a quarter of the two SpMM
    matrices (``life_matrices``).
    Returns the kernel rows of the ``lifecycle`` path (one call of each
    measured winner — the uniform one on both backends — and of the
    refreshed handle, replayed against the plain versions)."""
    import shutil

    from repro_torch import SpmmConfig, SpmmSession, compile_spmm
    from repro_torch.core import autotune
    from repro_torch.core.api import materialize_payload
    from repro_torch.core.planner import plan_build_count
    from repro_torch.kernels import ops
    from repro_torch.robustness import Fault, NumericalFault, inject

    t_phase = time.perf_counter()
    expect = EXPECT_SERVE_LADDER["quick" if args.quick else "full"]
    scratch = os.path.join(ROOT, "build", "lifecycle")
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)
    saved_env = {k: os.environ.pop(k, None)
                 for k in (autotune.CACHE_ENV, autotune.MEASURE_ENV)}
    os.environ[autotune.CACHE_ENV] = os.path.join(scratch, "autotune")
    hooks = []
    hook = autotune.register_profile_hook(hooks.append)
    a_u, a_p, b_host = life_matrices(args)
    b = torch.from_numpy(b_host).cuda()
    try:
        ops.reset_launch_counts()

        # 1. measured autotune, 2. the cache replay ---------------------
        # the two hier="auto" cells, then the same matrices flat (hier
        # None): with G = 2 the hier K sweep repeats one schedule, so the
        # top 3 candidates of "auto" are all hier and the flat tier is
        # timed by its own measured compile
        cells = {"uniform": (a_u, dict(backends=("coo", "bsr"),
                                        hier="auto", measure=True)),
                 "power_law": (a_p, dict(hier="auto", measure=True)),
                 "uniform_flat": (a_u, dict(backends=("coo", "bsr"),
                                             measure=True)),
                 "power_law_flat": (a_p, dict(measure=True))}
        winners, timed = {}, {}
        with warnings.catch_warnings(record=True) as caught, \
                autotune_watch() as watch:
            warnings.simplefilter("always")
            for name, (a, cfg) in cells.items():
                t0 = time.perf_counter()
                n_timed = len(watch.timed)
                h = compile_spmm(a, P, SpmmConfig(**cfg))
                timed[name] = watch.timed[n_timed:]
                log(f"lifecycle {name}: compile_spmm({cfg}) "
                    f"{time.perf_counter() - t0:.1f} s: {h}")
                winners[name] = h
            skipped = [str(w.message) for w in caught
                       if "autotune candidate" in str(w.message)]
            if skipped:
                raise AssertionError(f"lifecycle: autotune skipped a "
                                     f"candidate: {skipped}")
            model = list(watch.model)
        if len(model) != len(cells) or not all(timed.values()):
            raise AssertionError(f"lifecycle: {len(model)} measured overlays,"
                                 f" timed {[len(t) for t in timed.values()]}")
        cfg0 = SpmmConfig()
        for (name, h), m in zip(winners.items(), model):
            log(f"lifecycle {name} [{card}]: model-only decision "
                f"{json.dumps(dict(m, model_time=1e3 * m['model_time']))} "
                f"(alpha-beta model ms); measured winner "
                f"{json.dumps(_winner(h))}")
            for info in timed[name]:
                log(f"  candidate [{card}]: tier {info['tier']}, "
                    f"{info['kind']} K={info['K']}, overlap "
                    f"{info['overlap']}, backend {info['backend']}: model "
                    f"{1e3 * info['model_time']:.4f} ms (alpha-beta), "
                    f"measured {1e3 * info['measured_time']:.4f} ms (median "
                    f"of {cfg0.profile_iters} runs, N = {cfg0.n_dense_hint})")
        for name in ("uniform", "power_law"):
            best = {tier: min(timed[cell], key=lambda i: i["measured_time"])
                    for tier, cell in (("hier", name),
                                       ("flat", f"{name}_flat"))}
            log(f"lifecycle {name} [{card}]: the card's fastest timed hier "
                f"candidate {1e3 * best['hier']['measured_time']:.4f} ms, "
                f"flat {1e3 * best['flat']['measured_time']:.4f} ms; the "
                f"model picks {model[0 if name == 'uniform' else 1]['tier']}")
        c_first = {}
        for name, h in winners.items():
            a = cells[name][0]
            c_first[name] = h(b)
            check_rows(h, f"lifecycle {name}")
            log(f"  lifecycle {name}: max abs err vs scipy float64 "
                f"{check_c(c_first[name], a, b_host, name):.3g} (tol 2e-4); "
                f"rows == volume_rows_padded "
                f"{h.plan.volume_rows_padded(h.schedule)}")
        n_hooks = len(hooks)
        for name in ("uniform", "power_law"):
            a, cfg = cells[name]
            t0 = time.perf_counter()
            h2 = compile_spmm(a, P, SpmmConfig(**cfg))
            h1 = winners[name]
            same = {k: v for k, v in h2.decisions.items()
                    if k != "decision_source"} == {
                k: v for k, v in h1.decisions.items()
                if k != "decision_source"}
            if (len(hooks) != n_hooks or not same
                    or h2.decisions["decision_source"] != "cache"
                    or h1.decisions["decision_source"] != "measured"):
                raise AssertionError(f"lifecycle {name}: the cache replay "
                                     f"timed {len(hooks) - n_hooks} runs or "
                                     f"changed its decisions")
            if not torch.equal(h2(b), c_first[name]):
                raise AssertionError(f"lifecycle {name}: the replayed "
                                     f"handle's C differs")
            log(f"  lifecycle {name}: cache replay in "
                f"{time.perf_counter() - t0:.1f} s, 0 profile hooks, the "
                f"same decisions (source 'cache'), C bit-identical")
            del h2
        del c_first, winners["uniform_flat"], winners["power_law_flat"]

        # 3. memory per executable and donation -------------------------
        # the uniform coo cell at full size, then the small cases of
        # tests/test_torch_cuda.py (the reference's own pin among them)
        from repro_torch.core import sparse

        cases = {"uniform coo": (lambda sp: a_u, dict(backends=("coo",)),
                                 b_host)}
        for name, (make, cfg, n) in DONATION_CASES.items():
            cases[name] = (make, cfg, np.random.default_rng(4)
                           .standard_normal((make(sparse).shape[1], n))
                           .astype(np.float32))
        for name, (make, cfg, bh) in cases.items():
            d = donation_case(make(sparse), cfg, bh)
            if not (0 < d["donated"] < d["not"]
                    and d["not"] - d["donated"] <= bh.nbytes):
                raise AssertionError(f"lifecycle {name}: the first call "
                                     f"allocates {d}")
            log(f"lifecycle memory {name} [{card}]: {d['handle']}, first "
                f"call on a host B allocates {d['donated']} B donated, "
                f"{d['not']} B not ({d['donated'] / 2 ** 20:.2f} / "
                f"{d['not'] / 2 ** 20:.2f} MiB, B itself {bh.nbytes} B); "
                f"peak donated at {d['peak_donated']}, not at "
                f"{d['peak_not']}; C bit-identical; a caller's CUDA B "
                f"untouched")

        # 4. the ladder ---------------------------------------------------
        cfg_l = SpmmConfig(hier="auto", measure=False)
        n0 = plan_build_count()
        t0 = time.perf_counter()
        s = SpmmSession.build(a_p, P, cfg_l, p_ladder=(4, 8))
        if plan_build_count() - n0 != 2:
            raise AssertionError(f"lifecycle: the ladder ran "
                                 f"{plan_build_count() - n0} MWVC builds")
        log(f"lifecycle ladder: SpmmSession.build(power-law, p_ladder=(4, "
            f"8)) {time.perf_counter() - t0:.1f} s, 2 MWVC builds")
        n1 = plan_build_count()
        h8 = s.handle()
        for p in (8, 4, 8):
            h = s.on_resize(p)
            check_decisions(h, expect[p], {}, f"lifecycle rung P={p}")
            c = h(b)
            check_rows(h, f"lifecycle rung P={p}")
            log(f"  rung P={p}: max abs err vs scipy float64 "
                f"{check_c(c, a_p, b_host, f'rung {p}'):.3g} (tol 2e-4)")
        if s.handle() is not h8 or plan_build_count() != n1:
            raise AssertionError("lifecycle: on_resize re-planned")
        log("  on_resize(4), on_resize(8): no MWVC build, rung 8's handle "
            "kept")

        # 5. values-only drift ------------------------------------------
        rng = np.random.default_rng(5)
        a_v = dataclasses.replace(a_p, data=(a_p.data * rng.uniform(
            0.5, 1.5, a_p.nnz)).astype(np.float32))
        lowerings = len(h8.lowerings)
        drift = s.maybe_replan(a_v)
        c_v = h8(b)
        if (drift != (0.0, False) or s.handle() is not h8
                or h8.values_refreshes != 1 or s.values_refreshes != 1
                or len(h8.lowerings) != lowerings):
            raise AssertionError(f"lifecycle: values-only drift {drift}, "
                                 f"{h8.values_refreshes} refreshes, "
                                 f"{len(h8.lowerings)} memo entries")
        cold = compile_spmm(a_v, P, cfg_l)
        if not torch.equal(c_v, cold(b)):
            raise AssertionError("lifecycle: refreshed C != a cold compile's")
        log(f"lifecycle values-only drift: (drift, replanned) {drift}, 1 "
            f"refresh, {lowerings} memo entries kept, C == a cold compile's "
            f"bit for bit, max abs err vs scipy float64 "
            f"{check_c(c_v, a_v, b_host, 'refreshed'):.3g} (tol 2e-4)")
        refreshed_call = lambda: h8(b)  # noqa: E731
        del cold

        # 6. pattern drift ----------------------------------------------
        a_r = rewire(a_v, 0.15, seed=6)
        keys = h8.cache_info()["keys"]
        n2 = plan_build_count()
        d, swapped = s.maybe_replan(a_r)
        hn = s.handle()
        hits = hn.cache_hits
        c_r = hn(b)
        if (not swapped or d <= cfg_l.drift_threshold or hn is h8
                or hn.cache_info()["keys"] != keys
                or hn.cache_hits != hits + 1
                or plan_build_count() - n2 != 1):
            raise AssertionError(f"lifecycle: pattern drift {d} swapped "
                                 f"{swapped}, warmed {hn.cache_info()}, "
                                 f"{plan_build_count() - n2} MWVC builds")
        log(f"lifecycle pattern drift: 15% of the edges rewired, drift "
            f"{d:.4f} > {cfg_l.drift_threshold}: hot swap to {hn}, warmed "
            f"{len(keys)} memo entr(y/ies), the first call a hit, 1 MWVC "
            f"build, max abs err vs scipy float64 "
            f"{check_c(c_r, a_r, b_host, 'swapped'):.3g} (tol 2e-4)")

        # 7. the bundle --------------------------------------------------
        path = os.path.join(scratch, "bundle")
        s.save(path)
        loaded = SpmmSession.load(path, P)
        if not torch.equal(loaded.handle()(b), c_r):
            raise AssertionError("lifecycle: the loaded bundle's C differs")
        del loaded
        torn = os.path.join(scratch, "torn")
        with inject([Fault(kind="torn_checkpoint", site="atomic_dir",
                           file="rung", mode="truncate")]) as plan:
            s.save(torn, include_operand=False)
        try:
            SpmmSession.load(torn, P)
        except ValueError as e:
            if "rung_P" not in str(e):
                raise
            log(f"lifecycle bundle: save / load C bit-identical; a torn "
                f"save ({plan.fired('torn_checkpoint')} fault) fails to "
                f"load: {str(e)[:90]}...")
        else:
            raise AssertionError("lifecycle: a torn bundle loaded")

        # 8. faults ------------------------------------------------------
        with inject([Fault(kind="nan_poison", site="output")]):
            try:
                hn(b)
            except NumericalFault:
                pass
            else:
                raise AssertionError("lifecycle: nan_poison went unseen")
        if hn.stats()["numerical_faults"] != 1:
            raise AssertionError("lifecycle: numerical_faults != 1")
        cfg_c = SpmmConfig(measure=True, profile_topk=1)
        cache_dir = os.environ[autotune.CACHE_ENV]
        before = set(os.listdir(cache_dir))
        with inject([Fault(kind="autotune_corrupt", site="autotune_cache",
                           mode="empty")]) as plan:
            compile_spmm(a_p, P, cfg_c)
        (entry,) = [os.path.join(cache_dir, f)
                    for f in set(os.listdir(cache_dir)) - before]
        if plan.fired("autotune_corrupt") != 1 or os.path.getsize(entry):
            raise AssertionError("lifecycle: the cache entry was not torn")
        n_hooks = len(hooks)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            hc = compile_spmm(a_p, P, cfg_c)
        if (not any("zero-byte entry" in str(w.message) for w in caught)
                or len(hooks) == n_hooks or not os.path.getsize(entry)
                or hc.decisions["decision_source"] != "measured"):
            raise AssertionError("lifecycle: a torn cache entry was not "
                                 "re-profiled and rewritten")
        payload = hn.save_payload()
        payload["config"] = dataclasses.replace(hn.config, check=False)
        if not torch.equal(materialize_payload(payload, P)(b), hn(b)):
            raise AssertionError("lifecycle: check=False C != check='auto'")
        log(f"lifecycle faults: nan_poison at output raised NumericalFault "
            f"(numerical_faults 1); a torn autotune entry warned, "
            f"re-profiled ({len(hooks) - n_hooks} runs) and was rewritten; "
            f"with no plan check=False C == check='auto' C bit for bit")
        del hc, payload
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        log(f"lifecycle launches (the phase's counted run): "
            f"{json.dumps(launches)}")
        want = ["gather_rows", "gather_rows_scaled", "scatter_add_rows",
                "bsr_spmm"]
        if any(i["backend"] == "bsr" and i["overlap"]
               for t in timed.values() for i in t):
            want.append("bsr_spmm_acc")
        if min(launches[k] for k in want) < 1:
            raise AssertionError(f"lifecycle: a kernel was not launched "
                                 f"({want}): {launches}")

        # 9. the kernels of one call of each winner and of the refreshed
        #    handle, against their plain versions
        uni = winners["uniform"]
        rec = record_kernel_calls(lambda: (
            uni(b, backend="coo"), uni(b, backend="bsr"),
            winners["power_law"](b), refreshed_call()))
        paths = {k: {"lifecycle": (rec, launches)} for k in
                 ("gather_rows", "gather_rows_scaled", "scatter_add_rows",
                  "bsr_spmm", "bsr_spmm_acc") if rec[k]}
        rows = replay_paths(paths)
        del rec, winners, uni, s, h8, hn, c_v, c_r, refreshed_call, b
    finally:
        autotune.unregister_profile_hook(hook)
        for k, v in saved_env.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
        shutil.rmtree(scratch, ignore_errors=True)
    log(f"phase 8 lifecycle: {time.perf_counter() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 9: serving waves and the fleet
# ---------------------------------------------------------------------------


def _timed(fn):
    """(fn(), device ms by CUDA events, host wall ms) of one call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


class ColdCompiles:
    """One cold ``compile_spmm`` per distinct (pattern, P, config), its C
    on the phase's B checked within 2e-4 of scipy float64 once."""

    def __init__(self, b: torch.Tensor, b_host: np.ndarray):
        self.b, self.b_host, self.c = b, b_host, {}

    def __call__(self, a, tag: str, P_: int, cfg) -> torch.Tensor:
        from repro_torch import compile_spmm

        key = (tag, P_, cfg)
        if key not in self.c:
            c = compile_spmm(a, P_, cfg)(self.b)
            log(f"  cold compile {tag} P={P_}: max abs err vs scipy float64 "
                f"{check_c(c, a, self.b_host, f'{tag} P={P_}'):.3g} "
                f"(tol 2e-4)")
            self.c[key] = c
        return self.c[key]


def _same(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if not (got.is_cuda and torch.equal(got, want)):
        raise AssertionError(f"{what}: served C != the cold compile's")


def wave_serving(args, card, a_p, a_r, b_host, cold) -> dict:
    """Phase 9, part 1: an ``SpmmWaveServer`` over the power-law session
    (ladder (4, 8)) attached to an ``ElasticController``, on a host B,
    through census 8 -> 5 -> 8, a drift replan and two injected wave
    faults. Returns the served handles' first-call memory."""
    from repro_torch import (
        ElasticController, SpmmConfig, SpmmRequest, SpmmSession,
        SpmmWaveServer,
    )
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.planner import plan_build_count
    from repro_torch.robustness import Fault, inject

    expect = EXPECT_SERVE_LADDER["quick" if args.quick else "full"]
    cfg = SpmmConfig(hier="auto", measure=False)
    t0 = time.perf_counter()
    s = SpmmSession.build(a_p, P, cfg, p_ladder=(4, 8))
    ctl = ElasticController(get_smoke_config("qwen2-1.5b"), global_batch=8)
    ctl.attach_spmm(s)
    server = SpmmWaveServer(s, max_batch=2, backoff=0.0)
    log(f"waves: SpmmSession.build(power-law, p_ladder=(4, 8)) "
        f"{time.perf_counter() - t0:.1f} s, SpmmWaveServer(max_batch=2)")
    rid = iter(range(10 ** 6))
    memory = {}

    def wave(a, tag, n=2):
        reqs = [SpmmRequest(rid=next(rid), b=b_host) for _ in range(n)]
        for r in reqs:
            server.submit(r)
        server.run()
        h = s.handle()
        check_rows(h, f"wave {tag} P={h.P}")
        want = cold(a, tag, h.P, cfg)
        for r in reqs:
            _same(r.output, want, f"wave {tag} P={h.P} request {r.rid}")
        memory.setdefault(f"{tag} P={h.P}",
                          h.stats()["total_allocation_size"])
        return h

    builds = 0

    def census(n):
        nonlocal builds
        n0 = plan_build_count()
        ctl.on_census(n)
        builds += plan_build_count() - n0

    census(8)
    check_decisions(wave(a_p, "power-law"), expect[8], {}, "wave rung P=8")
    census(5)
    check_decisions(wave(a_p, "power-law"), expect[4], {}, "wave rung P=4")
    census(8)
    wave(a_p, "power-law")
    if builds or s.current_P != 8:
        raise AssertionError(f"waves: the census changes ran {builds} "
                             f"MWVC builds")
    d, swapped = s.maybe_replan(a_r)
    if not swapped:
        raise AssertionError(f"waves: drift {d} did not replan")
    wave(a_r, "rewired")
    with inject([Fault(kind="wave_error", site="wave", times=2)]) as plan:
        wave(a_r, "rewired")  # fails twice at P=8, served at rung 4
    st = server.stats
    got = (st.failed_waves, st.retried_waves, st.degraded_rungs,
           st.dropped_waves, plan.fired("wave_error"), s.current_P)
    if got != (2, 1, 1, 0, 2, 4):
        raise AssertionError(f"waves: (failed, retried, degraded, dropped, "
                             f"fired, P) {got}")
    rungs = [e["rung"] for e in ctl.events if e["action"] == "spmm_rung"]
    if rungs != [8, 4, 8]:
        raise AssertionError(f"waves: the controller's rungs {rungs}")
    log(f"waves: census 8 -> 5 -> 8 served rungs {rungs} with no MWVC "
        f"build; 15% of the edges rewired, drift {d:.4f}: hot swap; "
        f"wave_error x 2 at P=8: retried, degraded to rung 4 and served; "
        f"every request's C == a cold compile's on its (P, pattern); "
        f"server {json.dumps(dataclasses.asdict(st))}")

    # requests per second on a host B at P = 8, each wave's H2D copy,
    # donated private copy and closing synchronize included
    s.on_resize(8)
    n_req = 16
    reqs = [SpmmRequest(rid=next(rid), b=b_host) for _ in range(n_req)]
    for r in reqs:
        server.submit(r)
    _, dev_ms, host_ms = _timed(server.run)
    want = cold(a_r, "rewired", 8, cfg)
    for r in reqs:
        _same(r.output, want, f"timed wave request {r.rid}")
    # the same requests on the card's copy of B: no H2D copy, no private
    # copy to donate
    b = torch.from_numpy(b_host).cuda()
    on_card = [SpmmRequest(rid=next(rid), b=b) for _ in range(n_req)]
    for r in on_card:
        server.submit(r)
    _, dev_card, host_card = _timed(server.run)
    for r in on_card:
        _same(r.output, want, f"timed wave request {r.rid} (card B)")
    log(f"waves [{card}]: {n_req} requests on a host B [{b_host.shape[0]}, "
        f"{b_host.shape[1]}] float32 in {n_req // 2} waves at P=8: "
        f"{dev_ms / n_req:.3f} ms per request (CUDA events), "
        f"{host_ms / n_req:.3f} ms (host wall), "
        f"{n_req / host_ms * 1e3:.1f} requests/s; on the card's B "
        f"{dev_card / n_req:.3f} / {host_card / n_req:.3f} ms, "
        f"{n_req / host_card * 1e3:.1f} requests/s")
    if server.stats.dropped_waves:
        raise AssertionError("waves: a wave was dropped")
    return memory


def fleet_serving(args, card, a_p, a_r, b, b_host, cold) -> dict:
    """Phase 9, part 2: three tenants on ``SpmmFleet(Topology.local(8),
    group_sizes=(4, 4))`` — placements in both admission orders, serving,
    one rebalance migration, a drift replan, a rolled-back migration.
    Returns {tenant: first-call memory}."""
    from repro_torch import ReshardSpec, SpmmConfig, SpmmFleet, Topology
    from repro_torch.core.planner import plan_build_count
    from repro_torch.core.sparse import block_rows, power_law_sparse
    from repro_torch.robustness import Fault, inject

    m = a_p.shape[0]
    lt = FLEET_LIGHT_QUICK if args.quick else FLEET_LIGHT
    nnz = (7 * 16_384 if args.quick else NNZ_FULL) // LIFE_SCALE
    t0 = time.perf_counter()
    mats = {"h1": a_p,
            "h2": power_law_sparse(m, m, nnz, 0.8, seed=FLEET_H2_SEED),
            "lt": power_law_sparse(lt["m"], lt["m"], lt["nnz"], 0.8,
                                   seed=lt["seed"])}
    b_lt_host = np.random.default_rng(9).standard_normal(
        (lt["m"], N_COLS)).astype(np.float32)
    bs = {"h1": (b, b_host), "h2": (b, b_host),
          "lt": (torch.from_numpy(b_lt_host).cuda(), b_lt_host)}
    cold_lt = ColdCompiles(*bs["lt"])
    cfg = SpmmConfig(n_dense_hint=N_COLS, measure=False)

    def cold_of(name, a, tag):
        return (cold_lt if name == "lt" else cold)(a, tag, 4, cfg)

    placements = []
    # the reversed order first: the fleet kept is admitted as pinned
    for order in (("lt", "h2", "h1"), ("h1", "h2", "lt")):
        fleet = SpmmFleet(Topology.local(P), group_sizes=(4, 4), config=cfg)
        for name in order:
            fleet.admit(name, mats[name])
        placements.append(fleet.placements())
    log(f"fleet: 3 tenants admitted twice (both orders) in "
        f"{time.perf_counter() - t0:.1f} s: placements {placements[0]}")
    scores = {n: t.scores for n, t in fleet.tenants.items()}
    if placements[0] != placements[1]:
        raise AssertionError(f"fleet: placements depend on the admission "
                             f"order: {placements}")
    if not args.quick and (placements[0] != EXPECT_FLEET["placements"]
                           or scores != EXPECT_FLEET["scores"]):
        raise AssertionError(f"fleet: placements {placements[0]}, scores "
                             f"{scores} != the reference's")

    live = {n: (n, mats[n]) for n in mats}  # tenant -> (tag, its pattern)

    def serve(what):
        for name in fleet.tenants:
            fleet.submit(name, bs[name][0])
        for name, (c,) in fleet.serve().items():
            _same(c, cold_of(name, live[name][1], live[name][0]),
                  f"fleet {what} {name}")

    serve("admitted")
    memory = {n: t.session.handle().stats()["total_allocation_size"]
              for n, t in fleet.tenants.items()}
    imb = fleet.imbalance()
    n0 = plan_build_count()
    moves, _, mig_ms = _timed(fleet.rebalance)
    after = fleet.imbalance()
    move = [e for e in fleet.events if e["action"] == "migrate"]
    if plan_build_count() != n0 or len(moves) != 1 or len(move) != 1:
        raise AssertionError(f"fleet: rebalance moved {moves} with "
                             f"{plan_build_count() - n0} MWVC builds")
    moved = {k: move[0][k] for k in ("b_rows", "c_rows")}
    if not args.quick and ((imb, after) != EXPECT_FLEET["imbalance"]
                           or moves != EXPECT_FLEET["moves"]
                           or moved != EXPECT_FLEET["moved"]):
        raise AssertionError(f"fleet: imbalance {imb} -> {after}, moves "
                             f"{moves}, moved {moved} != the reference's")
    name = moves[0][0]
    tenant = fleet.tenants[name]
    plan_ = tenant.session.handle().plan
    spec_b = ReshardSpec.between(block_rows(plan_.shape[1], plan_.P),
                                 block_rows(plan_.shape[1], plan_.P))
    spec_c = ReshardSpec.between(plan_.bounds, plan_.bounds)
    _, copy_ms, _ = _timed(lambda: (spec_b.apply(tenant.resident_b),
                                    spec_c.apply(tenant.resident_c)))
    log(f"fleet [{card}]: imbalance {imb:.4f} > {fleet.threshold} -> "
        f"rebalance {moves} in {mig_ms:.1f} ms (host wall: stage, warm, "
        f"reshard, commit; no MWVC build), imbalance {after:.4f}; moved "
        f"rows {moved}; the reshard copies of B and C "
        f"{copy_ms:.3f} ms (CUDA events)")
    serve("migrated")

    d, swapped = fleet.maybe_replan(name, a_r)
    if not swapped:
        raise AssertionError(f"fleet: drift {d} on {name} did not replan")
    live[name] = ("rewired", a_r)
    serve("drifted")

    src = fleet.placements()[name]
    with inject([Fault(kind="wave_error",
                       site="fleet_migrate_fail")]) as plan:
        ok = fleet.migrate(name, 1 - src)
    if (ok or plan.fired("wave_error") != 1 or fleet.failed_migrations != 1
            or fleet.placements()[name] != src):
        raise AssertionError("fleet: fleet_migrate_fail did not roll back")
    serve("rolled back")
    st = fleet.stats()
    dropped = {n: t["server"]["dropped_waves"]
               for n, t in st["tenants"].items()}
    if any(dropped.values()) or st["migrations"] != 1:
        raise AssertionError(f"fleet: dropped waves {dropped}, "
                             f"{st['migrations']} migrations")
    log(f"fleet: drift {d:.4f} on {name}: hot swap; an injected "
        f"fleet_migrate_fail rolled back and group {src} kept serving; "
        f"every wave's C == a cold compile's at P=4; dropped_waves "
        f"{dropped}")
    return fleet, memory


def cross_size_fleet(args, card, a_u, b, cold):
    """Phase 9, part 3: the uniform matrix on ``SpmmFleet(Topology.local(8),
    group_sizes=(4, 2))`` with the bsr backend (K3, and K4 in its
    overlapped schedules) migrates between groups of 2 and 4 ranks: real
    reshard routes, slabs that reassemble to the served B and C, and C at
    the new P equal to a cold compile. Returns the fleet."""
    from repro_torch import ReshardSpec, SpmmConfig, SpmmFleet, Topology
    from repro_torch.core.sparse import block_rows

    cfg = SpmmConfig(backends=("bsr", "coo"), n_dense_hint=N_COLS,
                     measure=False)
    expect = EXPECT_FLEET["cross"]
    t0 = time.perf_counter()
    fleet = SpmmFleet(Topology.local(P), group_sizes=(4, 2), config=cfg)
    gi = fleet.admit("u", a_u, p_ladder=(2, 4))
    tenant = fleet.tenants["u"]
    old_P = tenant.session.current_P
    log(f"cross-size fleet: uniform admitted to group {gi} (P={old_P}) in "
        f"{time.perf_counter() - t0:.1f} s, scores {tenant.scores}")
    if not args.quick and (gi != expect["group"]
                           or tenant.scores != expect["scores"]):
        raise AssertionError(f"cross-size fleet: group {gi}, scores "
                             f"{tenant.scores} != the reference's")
    fleet.submit("u", b)
    (c_old,) = fleet.serve()["u"]
    _same(c_old, cold(a_u, "uniform", old_P, cfg), f"cross-size P={old_P}")
    ok, _, mig_ms = _timed(lambda: fleet.migrate("u", 1 - gi))
    new_P = tenant.session.current_P
    move = [e for e in fleet.events if e["action"] == "migrate"]
    moved = {k: move[-1][k] for k in ("b_rows", "c_rows")} if move else {}
    if not ok or not moved or min(moved.values()) <= 0:
        raise AssertionError(f"cross-size fleet: migrated {ok}, {moved}")
    if not args.quick and ((old_P, new_P) != expect["P"]
                           or moved != expect["moved"]):
        raise AssertionError(f"cross-size fleet: P {old_P} -> {new_P}, "
                             f"moved {moved} != the reference's")
    if not (torch.equal(torch.cat(tenant.resident_b), b)
            and torch.equal(torch.cat(tenant.resident_c), c_old)):
        raise AssertionError("cross-size fleet: the resharded slabs do not "
                             "reassemble to the served B and C")
    # the same routes backwards, timed: the resident slabs' device copies
    back = ReshardSpec.between(block_rows(a_u.shape[0], new_P),
                               block_rows(a_u.shape[0], old_P))
    _, copy_ms, _ = _timed(lambda: (back.apply(tenant.resident_b),
                                    back.apply(tenant.resident_c)))
    fleet.submit("u", b)
    (c_new,) = fleet.serve()["u"]
    _same(c_new, cold(a_u, "uniform", new_P, cfg), f"cross-size P={new_P}")
    if tenant.server.stats.dropped_waves:
        raise AssertionError("cross-size fleet: a wave was dropped")
    log(f"cross-size fleet [{card}]: P {old_P} -> {new_P} in {mig_ms:.1f} "
        f"ms (host wall: stage, warm, reshard, commit); moved rows "
        f"{moved}; one reshard of B and C by device copies "
        f"{copy_ms:.3f} ms (CUDA events); the slabs reassemble to the "
        f"served B and C; C at both P == a cold compile's; "
        f"dropped_waves 0")
    return fleet


def serving_phase(args, card, a_u, a_p, b_host) -> dict:
    """Phase 9: serving waves and the fleet. Returns the kernel rows of
    the ``fleet`` path (one call of each fleet tenant's handle, replayed
    against the plain versions)."""
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    b = torch.from_numpy(b_host).cuda()
    cold = ColdCompiles(b, b_host)
    a_r = rewire(a_p, 0.15, seed=6)
    ops.reset_launch_counts()
    memory = wave_serving(args, card, a_p, a_r, b_host, cold)
    fleet, fleet_memory = fleet_serving(args, card, a_p, a_r, b, b_host,
                                        cold)
    cross = cross_size_fleet(args, card, a_u, b, cold)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"serving launches (the phase's counted run): "
        f"{json.dumps(launches)}")
    kernels = ("gather_rows", "gather_rows_scaled", "scatter_add_rows",
               "bsr_spmm", "bsr_spmm_acc")
    if min(launches[k] for k in kernels) < 1:
        raise AssertionError(f"serving: a kernel was not launched: "
                             f"{launches}")
    memory.update({f"fleet {n}": v for n, v in fleet_memory.items()})
    memory["cross-size u"] = cross.tenants["u"].session.handle().stats()[
        "total_allocation_size"]
    log(f"serving first-call memory [{card}]: "
        + ", ".join(f"{k} {v} B ({v / 2 ** 20:.2f} MiB)"
                    for k, v in memory.items()))

    # the kernels of one call of each fleet tenant's handle
    lt = FLEET_LIGHT_QUICK if args.quick else FLEET_LIGHT
    b_lt = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (lt["m"], N_COLS)).astype(np.float32)).cuda()
    handles = [(fleet.tenants["h1"], b), (fleet.tenants["h2"], b),
               (fleet.tenants["lt"], b_lt), (cross.tenants["u"], b)]
    rec = record_kernel_calls(lambda: [t.session.handle()(x)
                                       for t, x in handles])
    missing = [k for k in kernels if not rec[k]]
    if missing:
        raise AssertionError(f"serving: no {missing} call recorded")
    rows = replay_paths({k: {"fleet": (rec, launches)} for k in kernels})
    del rec, handles, fleet, cross, cold, b, b_lt
    log(f"phase 9 serving: {time.perf_counter() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 11: SHIRO across two processes on the one card
# ---------------------------------------------------------------------------

MP_NPROC, MP_LOCAL = 2, 4  # processes x ranks each: P = 8, tiers (2, 4)
MP_TIMEOUT = 300  # seconds: every wait of the phase, collectives included
# phase 12's workers in all (the LM cases with their checkpoints, the
# families, the GCN / GAT cells, the EP LM, the replays: ~330 s)
MP_TRAIN_TIMEOUT = 600
MP_DEVICE = "cuda"  # every worker's ranks run on the card
# the three handles each worker compiles on the fleet's Topology (hier=
# "auto" resolves to the fleet's tiers; the uniform one runs K3 / K4)
MP_CELLS = (("mp-powerlaw-arxiv flat", "power_law", "mp_flat",
             dict(backends=("coo",))),
            ("mp-powerlaw-arxiv hier", "power_law", "mp_hier",
             dict(backends=("coo",), hier="auto")),
            ("mp-uniform-arxiv hier", "uniform", "mp_uniform_hier",
             dict(backends=("bsr",), hier="auto")))
MP_KERNELS = {"power_law": ("gather_rows", "gather_rows_scaled",
                            "scatter_add_rows"),
              "uniform": ("gather_rows", "scatter_add_rows", "bsr_spmm",
                          "bsr_spmm_acc")}
# the reference's decisions with the fleet's derived NetworkSpec
# (derived-gpu-2x4: 450 / 25 GB/s, group 4; the JAX package's
# _plan_and_tune on the same matrices, CPU run), and the padded rows each
# plan sends across the two processes (``DistSpmm.plan_crossing_rows``'s
# count on the reference's schedule) beside its unpadded slow-tier rows
# (B, C) and the flat plan's; on a quarter of arxiv since phase 11 was
# cut to it: scripts/reference_fleet_pins.py (--scale 1: the full-size
# pins)
EXPECT_MP = {
    "full": {
        "mp-powerlaw-arxiv flat": dict(
            strategy="flat", net="derived-gpu-2x4", schedule_kind="bucketed",
            schedule_K=4, overlap=True,
            modeled_time_flat=0.00027343890133333336, volume_rows=67604,
            volume_rows_padded=214696, crossing_padded=122146,
            slow_tier_rows=(5038, 30364), slow_tier_rows_flat_plan=(5038,
            30364)),
        "mp-powerlaw-arxiv hier": dict(
            strategy="hier", G=2, L=4, net="derived-gpu-2x4",
            schedule_kind="bucketed", schedule_K=1, overlap=True,
            modeled_time_flat=0.00027343890133333336,
            modeled_time_hier=5.7223648000000003e-05, volume_rows=67604,
            volume_rows_padded=45904, crossing_padded=45904,
            slow_tier_rows=(3816, 21887), slow_tier_rows_flat_plan=(5038,
            30364)),
        "mp-uniform-arxiv hier": dict(
            strategy="hier", G=2, L=4, net="derived-gpu-2x4",
            schedule_kind="bucketed", schedule_K=1, overlap=True,
            modeled_time_flat=0.000297976608,
            modeled_time_hier=8.628572800000001e-05, volume_rows=147373,
            volume_rows_padded=51720, crossing_padded=51720,
            slow_tier_rows=(13951, 36912), slow_tier_rows_flat_plan=(16164,
            68097)),
    },
    "quick": {
        "mp-powerlaw-arxiv flat": dict(
            strategy="flat", net="derived-gpu-2x4", schedule_kind="bucketed",
            schedule_K=1, overlap=True, modeled_time_flat=9.12432888888889e-05,
            volume_rows=7229, volume_rows_padded=32144, crossing_padded=18368,
            slow_tier_rows=(598, 3249), slow_tier_rows_flat_plan=(598, 3249)),
        "mp-powerlaw-arxiv hier": dict(
            strategy="hier", G=2, L=4, net="derived-gpu-2x4",
            schedule_kind="bucketed", schedule_K=1, overlap=True,
            modeled_time_flat=9.12432888888889e-05,
            modeled_time_hier=2.389232e-05, volume_rows=7229,
            volume_rows_padded=4776, crossing_padded=4776, slow_tier_rows=(443,
            2306), slow_tier_rows_flat_plan=(598, 3249)),
        "mp-uniform-arxiv hier": dict(
            strategy="hier", G=2, L=4, net="derived-gpu-2x4",
            schedule_kind="bucketed", schedule_K=1, overlap=True,
            modeled_time_flat=9.26380977777778e-05,
            modeled_time_hier=2.6402720000000002e-05, volume_rows=14440,
            volume_rows_padded=5104, crossing_padded=5104,
            slow_tier_rows=(1295, 3614), slow_tier_rows_flat_plan=(1482, 6807)),
    },
}


# phase 11 (b)'s sessions across the processes: the MoE dispatch of one
# 8 x 128 prefill (phase 7's DISPATCH at the model's width, float32), and
# a ladder below the fleet on the cells' power-law and uniform matrices:
# rung 8, on_resize(6) (spans [(0, 4), (4, 6)]), on_resize(4) (worker 1
# holds no rank), the group [2, 6) carved across the boundary, and back
# to 8. Six ranks need 6 | M: the --quick rungs take 4080 nodes (4096
# rounded down to 24 | M), the full ones the cells' 42,336.
MP_LADDER = (4, 6, 8)
MP_RUNG_CELLS = (("mp-powerlaw-arxiv flat", "power_law", "mp_rung_power_law",
                  dict(backends=("coo",))),
                 ("mp-uniform-arxiv hier", "uniform", "mp_rung_uniform",
                  dict(backends=("bsr",), hier="auto")))
MP_RUNG_SPANS = {"p8": [[0, 4], [4, 8]], "p6": [[0, 4], [4, 6]],
                 "p4": [[0, 4], [4, 4]], "group26": [[0, 2], [2, 4]],
                 "back8": [[0, 4], [4, 8]]}
# the steps whose kernel calls and launches make a rung path (those below
# the whole fleet: rung 8's plan is the cells' own, replayed there)
MP_RUNG_PATH_STEPS = ("p6", "p4", "group26")
MP_DISPATCH_DRIFTS = ("drift_ok", "values_refresh", "drift_replan")
MP_DISPATCH_KERNELS = ("gather_rows", "gather_rows_scaled", "scatter_add_rows")
# phase 11 (b)'s SpmmFleet on the process fleet (mp_fleet): phase 9's
# tenants (FLEET_H2_SEED, FLEET_LIGHT) admitted in this order on groups
# (4, 4) (one a worker), rebalanced and served, a migration rolled back by
# a fault on one worker alone; then h1 with rungs (2, 6) on groups (2, 6)
# migrated into group 1, which straddles the workers (coo: K1, K1 scaled,
# K2)
MP_FLEET_SPLIT, MP_FLEET_STRADDLE, MP_FLEET_LADDER = (4, 4), (2, 6), (2, 6)
MP_FLEET_ORDER = ("h1", "h2", "lt")
MP_FLEET_FAULT_WORKER = 1
# {path: the kernels it must launch}, every path of phase 11 (b)
MP_PATH_KERNELS = dict(
    [(path, MP_KERNELS[mat]) for _, mat, path, _ in MP_CELLS]
    + [("mp_dispatch", MP_DISPATCH_KERNELS),
       ("mp_dispatch_session", MP_DISPATCH_KERNELS)]
    + [(path, MP_KERNELS[mat]) for _, mat, path, _ in MP_RUNG_CELLS]
    + [("mp_fleet", MP_DISPATCH_KERNELS)])
# the reference's decisions at each step and its events (the adopted
# group's describe() left out: the reference's is a mesh's), from the JAX
# package's SpmmSession on a (2, 4) mesh of host devices with the fleet's
# network named: scripts/reference_fleet_pins.py
EXPECT_MP_RUNG = {'full': {'mp-powerlaw-arxiv flat': {'back8': {'modeled_time_flat': 0.00027343890133333336,
                                               'net': 'derived-gpu-2x4',
                                               'overlap': True,
                                               'schedule_K': 4,
                                               'schedule_kind': 'bucketed',
                                               'strategy': 'flat',
                                               'volume_rows': 67604,
                                               'volume_rows_padded': 214696},
                                     'events': [{'action': 'resize',
                                                 'census': 6,
                                                 'changed': True,
                                                 'rung': 6},
                                                {'action': 'resize',
                                                 'census': 4,
                                                 'changed': True,
                                                 'rung': 4},
                                                {'P': 4,
                                                 'action': 'adopt_topology'},
                                                {'action': 'resize',
                                                 'census': 8,
                                                 'changed': True,
                                                 'rung': 8}],
                                     'group26': {'modeled_time_flat': 3.0229052444444446e-05,
                                                 'net': 'derived-gpu-2x4',
                                                 'overlap': True,
                                                 'schedule_K': 1,
                                                 'schedule_kind': 'bucketed',
                                                 'strategy': 'flat',
                                                 'volume_rows': 44066,
                                                 'volume_rows_padded': 99144},
                                     'p4': {'modeled_time_flat': 3.0229052444444446e-05,
                                            'net': 'derived-gpu-2x4',
                                            'overlap': True,
                                            'schedule_K': 1,
                                            'schedule_kind': 'bucketed',
                                            'strategy': 'flat',
                                            'volume_rows': 44066,
                                            'volume_rows_padded': 99144},
                                     'p6': {'modeled_time_flat': 0.00018971724799999998,
                                            'net': 'derived-gpu-2x4',
                                            'overlap': True,
                                            'schedule_K': 3,
                                            'schedule_kind': 'bucketed',
                                            'strategy': 'flat',
                                            'volume_rows': 57718,
                                            'volume_rows_padded': 150108},
                                     'p8': {'modeled_time_flat': 0.00027343890133333336,
                                            'net': 'derived-gpu-2x4',
                                            'overlap': True,
                                            'schedule_K': 4,
                                            'schedule_kind': 'bucketed',
                                            'strategy': 'flat',
                                            'volume_rows': 67604,
                                            'volume_rows_padded': 214696}},
          'mp-uniform-arxiv hier': {'back8': {'G': 2,
                                              'L': 4,
                                              'modeled_time_flat': 0.000297976608,
                                              'modeled_time_hier': 8.628572800000001e-05,
                                              'net': 'derived-gpu-2x4',
                                              'overlap': True,
                                              'schedule_K': 1,
                                              'schedule_kind': 'bucketed',
                                              'strategy': 'hier',
                                              'volume_rows': 147373,
                                              'volume_rows_padded': 51720},
                                    'events': [{'action': 'resize',
                                                'census': 6,
                                                'changed': True,
                                                'rung': 6},
                                               {'action': 'resize',
                                                'census': 4,
                                                'changed': True,
                                                'rung': 4},
                                               {'P': 4,
                                                'action': 'adopt_topology'},
                                               {'action': 'resize',
                                                'census': 8,
                                                'changed': True,
                                                'rung': 8}],
                                    'group26': {'modeled_time_flat': 3.478785066666667e-05,
                                                'modeled_time_hier': 0.00014471958400000002,
                                                'net': 'derived-gpu-2x4',
                                                'overlap': True,
                                                'schedule_K': 1,
                                                'schedule_kind': 'bucketed',
                                                'strategy': 'flat',
                                                'volume_rows': 92725,
                                                'volume_rows_padded': 96084},
                                    'p4': {'modeled_time_flat': 3.478785066666667e-05,
                                           'modeled_time_hier': 0.00014471958400000002,
                                           'net': 'derived-gpu-2x4',
                                           'overlap': True,
                                           'schedule_K': 1,
                                           'schedule_kind': 'bucketed',
                                           'strategy': 'flat',
                                           'volume_rows': 92725,
                                           'volume_rows_padded': 96084},
                                    'p6': {'G': 2,
                                           'L': 3,
                                           'modeled_time_flat': 0.00039722868266666664,
                                           'modeled_time_hier': 0.00010703198933333334,
                                           'net': 'derived-gpu-2x4',
                                           'overlap': True,
                                           'schedule_K': 1,
                                           'schedule_kind': 'bucketed',
                                           'strategy': 'hier',
                                           'volume_rows': 124756,
                                           'volume_rows_padded': 50508},
                                    'p8': {'G': 2,
                                           'L': 4,
                                           'modeled_time_flat': 0.000297976608,
                                           'modeled_time_hier': 8.628572800000001e-05,
                                           'net': 'derived-gpu-2x4',
                                           'overlap': True,
                                           'schedule_K': 1,
                                           'schedule_kind': 'bucketed',
                                           'strategy': 'hier',
                                           'volume_rows': 147373,
                                           'volume_rows_padded': 51720}}},
 'quick': {'mp-powerlaw-arxiv flat': {'back8': {'modeled_time_flat': 9.114352000000001e-05,
                                                'net': 'derived-gpu-2x4',
                                                'overlap': True,
                                                'schedule_K': 1,
                                                'schedule_kind': 'bucketed',
                                                'strategy': 'flat',
                                                'volume_rows': 7232,
                                                'volume_rows_padded': 31752},
                                      'events': [{'action': 'resize',
                                                  'census': 6,
                                                  'changed': True,
                                                  'rung': 6},
                                                 {'action': 'resize',
                                                  'census': 4,
                                                  'changed': True,
                                                  'rung': 4},
                                                 {'P': 4,
                                                  'action': 'adopt_topology'},
                                                 {'action': 'resize',
                                                  'census': 8,
                                                  'changed': True,
                                                  'rung': 8}],
                                      'group26': {'modeled_time_flat': 8.456704e-06,
                                                  'net': 'derived-gpu-2x4',
                                                  'overlap': True,
                                                  'schedule_K': 1,
                                                  'schedule_kind': 'bucketed',
                                                  'strategy': 'flat',
                                                  'volume_rows': 4659,
                                                  'volume_rows_padded': 10776},
                                      'p4': {'modeled_time_flat': 8.456704e-06,
                                             'net': 'derived-gpu-2x4',
                                             'overlap': True,
                                             'schedule_K': 1,
                                             'schedule_kind': 'bucketed',
                                             'strategy': 'flat',
                                             'volume_rows': 4659,
                                             'volume_rows_padded': 10776},
                                      'p6': {'modeled_time_flat': 6.463349688888888e-05,
                                             'net': 'derived-gpu-2x4',
                                             'overlap': True,
                                             'schedule_K': 1,
                                             'schedule_kind': 'bucketed',
                                             'strategy': 'flat',
                                             'volume_rows': 6209,
                                             'volume_rows_padded': 20730},
                                      'p8': {'modeled_time_flat': 9.114352000000001e-05,
                                             'net': 'derived-gpu-2x4',
                                             'overlap': True,
                                             'schedule_K': 1,
                                             'schedule_kind': 'bucketed',
                                             'strategy': 'flat',
                                             'volume_rows': 7232,
                                             'volume_rows_padded': 31752}},
           'mp-uniform-arxiv hier': {'back8': {'G': 2,
                                               'L': 4,
                                               'modeled_time_flat': 9.263053511111111e-05,
                                               'modeled_time_hier': 2.6422464000000005e-05,
                                               'net': 'derived-gpu-2x4',
                                               'overlap': True,
                                               'schedule_K': 1,
                                               'schedule_kind': 'bucketed',
                                               'strategy': 'hier',
                                               'volume_rows': 14428,
                                               'volume_rows_padded': 5160},
                                     'events': [{'action': 'resize',
                                                 'census': 6,
                                                 'changed': True,
                                                 'rung': 6},
                                                {'action': 'resize',
                                                 'census': 4,
                                                 'changed': True,
                                                 'rung': 4},
                                                {'P': 4,
                                                 'action': 'adopt_topology'},
                                                {'action': 'resize',
                                                 'census': 8,
                                                 'changed': True,
                                                 'rung': 8}],
                                     'group26': {'modeled_time_flat': 8.802062222222222e-06,
                                                 'modeled_time_hier': 3.208832e-05,
                                                 'net': 'derived-gpu-2x4',
                                                 'overlap': True,
                                                 'schedule_K': 1,
                                                 'schedule_kind': 'bucketed',
                                                 'strategy': 'flat',
                                                 'volume_rows': 9008,
                                                 'volume_rows_padded': 10032},
                                     'p4': {'modeled_time_flat': 8.802062222222222e-06,
                                            'modeled_time_hier': 3.208832e-05,
                                            'net': 'derived-gpu-2x4',
                                            'overlap': True,
                                            'schedule_K': 1,
                                            'schedule_kind': 'bucketed',
                                            'strategy': 'flat',
                                            'volume_rows': 9008,
                                            'volume_rows_padded': 10032},
                                     'p6': {'G': 2,
                                            'L': 3,
                                            'modeled_time_flat': 8.395239822222222e-05,
                                            'modeled_time_hier': 2.837572266666667e-05,
                                            'net': 'derived-gpu-2x4',
                                            'overlap': True,
                                            'schedule_K': 1,
                                            'schedule_kind': 'bucketed',
                                            'strategy': 'hier',
                                            'volume_rows': 12174,
                                            'volume_rows_padded': 4974},
                                     'p8': {'G': 2,
                                            'L': 4,
                                            'modeled_time_flat': 9.263053511111111e-05,
                                            'modeled_time_hier': 2.6422464000000005e-05,
                                            'net': 'derived-gpu-2x4',
                                            'overlap': True,
                                            'schedule_K': 1,
                                            'schedule_kind': 'bucketed',
                                            'strategy': 'hier',
                                            'volume_rows': 14428,
                                            'volume_rows_padded': 5160}}}}
# the reference's compile_dispatch decisions on the fleet's network, then
# dispatch_session through maybe_replan of the planned routing, of its
# values halved and of the seed-1 routing: each step's decisions and
# return, and the events (scripts/reference_fleet_pins.py)
EXPECT_MP_DISPATCH = {'full': {'drift_ok': {'backends': ['coo'],
                       'modeled_time_schedule': 2.78848e-05,
                       'net': 'derived-gpu-2x4',
                       'overlap': True,
                       'pattern_nnz': 8192,
                       'plan_strategy': 'joint',
                       'schedule_K': 1,
                       'schedule_kind': 'bucketed',
                       'shape': [8424, 1024],
                       'strategy': 'flat',
                       'volume_rows': 4917,
                       'volume_rows_padded': 6160,
                       'volume_rows_padded_single': 7040},
          'drift_replan': {'backends': ['coo'],
                           'modeled_time_schedule': 2.82432e-05,
                           'net': 'derived-gpu-2x4',
                           'overlap': True,
                           'pattern_nnz': 8192,
                           'plan_strategy': 'joint',
                           'schedule_K': 1,
                           'schedule_kind': 'bucketed',
                           'shape': [8488, 1024],
                           'strategy': 'flat',
                           'volume_rows': 4853,
                           'volume_rows_padded': 6440,
                           'volume_rows_padded_single': 7360},
          'events': [{'action': 'drift_ok', 'drift': 0.0},
                     {'action': 'values_refresh', 'drift': 0.0},
                     {'action': 'drift_replan', 'drift': 1.0},
                     {'action': 'replan',
                      'drift': 1.0,
                      'generation': 1,
                      'rungs': [8]}],
          'handle': {'backends': ['coo'],
                     'modeled_time_schedule': 2.78848e-05,
                     'net': 'derived-gpu-2x4',
                     'overlap': True,
                     'pattern_nnz': 8192,
                     'plan_strategy': 'joint',
                     'schedule_K': 1,
                     'schedule_kind': 'bucketed',
                     'shape': [8424, 1024],
                     'strategy': 'flat',
                     'volume_rows': 4917,
                     'volume_rows_padded': 6160,
                     'volume_rows_padded_single': 7040},
          'replan-drift_ok': [0.0, False],
          'replan-drift_replan': [1.0, True],
          'replan-values_refresh': [0.0, False],
          'values_refresh': {'backends': ['coo'],
                             'modeled_time_schedule': 2.78848e-05,
                             'net': 'derived-gpu-2x4',
                             'overlap': True,
                             'pattern_nnz': 8192,
                             'plan_strategy': 'joint',
                             'schedule_K': 1,
                             'schedule_kind': 'bucketed',
                             'shape': [8424, 1024],
                             'strategy': 'flat',
                             'volume_rows': 4917,
                             'volume_rows_padded': 6160,
                             'volume_rows_padded_single': 7040}},
 'quick': {'drift_ok': {'backends': ['coo'],
                        'modeled_time_schedule': 1.3297280000000001e-05,
                        'net': 'derived-gpu-2x4',
                        'overlap': True,
                        'pattern_nnz': 2048,
                        'plan_strategy': 'joint',
                        'schedule_K': 1,
                        'schedule_kind': 'bucketed',
                        'shape': [2304, 1024],
                        'strategy': 'flat',
                        'volume_rows': 1784,
                        'volume_rows_padded': 2576,
                        'volume_rows_padded_single': 3008},
           'drift_replan': {'backends': ['coo'],
                            'modeled_time_schedule': 1.365568e-05,
                            'net': 'derived-gpu-2x4',
                            'overlap': True,
                            'pattern_nnz': 2048,
                            'plan_strategy': 'joint',
                            'schedule_K': 1,
                            'schedule_kind': 'bucketed',
                            'shape': [2224, 1024],
                            'strategy': 'flat',
                            'volume_rows': 1780,
                            'volume_rows_padded': 2856,
                            'volume_rows_padded_single': 3328},
           'events': [{'action': 'drift_ok', 'drift': 0.0},
                      {'action': 'values_refresh', 'drift': 0.0},
                      {'action': 'drift_replan', 'drift': 1.0},
                      {'action': 'replan',
                       'drift': 1.0,
                       'generation': 1,
                       'rungs': [8]}],
           'handle': {'backends': ['coo'],
                      'modeled_time_schedule': 1.3297280000000001e-05,
                      'net': 'derived-gpu-2x4',
                      'overlap': True,
                      'pattern_nnz': 2048,
                      'plan_strategy': 'joint',
                      'schedule_K': 1,
                      'schedule_kind': 'bucketed',
                      'shape': [2304, 1024],
                      'strategy': 'flat',
                      'volume_rows': 1784,
                      'volume_rows_padded': 2576,
                      'volume_rows_padded_single': 3008},
           'replan-drift_ok': [0.0, False],
           'replan-drift_replan': [1.0, True],
           'replan-values_refresh': [0.0, False],
           'values_refresh': {'backends': ['coo'],
                              'modeled_time_schedule': 1.3297280000000001e-05,
                              'net': 'derived-gpu-2x4',
                              'overlap': True,
                              'pattern_nnz': 2048,
                              'plan_strategy': 'joint',
                              'schedule_K': 1,
                              'schedule_kind': 'bucketed',
                              'shape': [2304, 1024],
                              'strategy': 'flat',
                              'volume_rows': 1784,
                              'volume_rows_padded': 2576,
                              'volume_rows_padded_single': 3008}}}


# mp_fleet's decisions: the reference's SpmmFleet through the same steps on
# eight host devices as a (2, 4) mesh with SpmmConfig(n_dense_hint=128) (a
# carved group has no tiers on either side: every score on the model's
# default network), its ReshardSpec routes and moved rows, its counters and
# events: scripts/reference_fleet_pins.py (the JAX package, CPU run)
EXPECT_MP_FLEET = {'full': {'admitted': {'events': [{'action': 'admit',
                                   'group': 0,
                                   'scores': {'0': 3.220096e-05,
                                              '1': 3.220096e-05},
                                   'tenant': 'h1'},
                                  {'action': 'admit',
                                   'group': 0,
                                   'scores': {'0': 3.2187306666666665e-05,
                                              '1': 3.2187306666666665e-05},
                                   'tenant': 'h2'},
                                  {'action': 'admit',
                                   'group': 0,
                                   'scores': {'0': 1.5578026666666666e-05,
                                              '1': 1.5578026666666666e-05},
                                   'tenant': 'lt'}],
                       'failed_migrations': 0,
                       'imbalance': 2.0,
                       'migrations': 0,
                       'placements': {'h1': 0, 'h2': 0, 'lt': 0},
                       'scores': {'h1': {'0': [3.220096e-05, 47410796],
                                         '1': [3.220096e-05, 47410796]},
                                  'h2': {'0': [3.2187306666666665e-05,
                                               47406368],
                                         '1': [3.2187306666666665e-05,
                                               47406368]},
                                  'lt': {'0': [1.5578026666666666e-05,
                                               19042432],
                                         '1': [1.5578026666666666e-05,
                                               19042432]}}},
          'moves': [['h1', 1]],
          'rebalance': [{'b_routes': [[0, 0, 0, 10584],
                                      [1, 1, 10584, 21168],
                                      [2, 2, 21168, 31752],
                                      [3, 3, 31752, 42336]],
                         'c_routes': [[0, 0, 0, 10584],
                                      [1, 1, 10584, 21168],
                                      [2, 2, 21168, 31752],
                                      [3, 3, 31752, 42336]],
                         'moved': [0, 0]}],
          'rollback': ['h1', 0, False],
          'state': {'events': [{'action': 'admit',
                                'group': 0,
                                'scores': {'0': 3.220096e-05,
                                           '1': 3.220096e-05},
                                'tenant': 'h1'},
                               {'action': 'admit',
                                'group': 0,
                                'scores': {'0': 3.2187306666666665e-05,
                                           '1': 3.2187306666666665e-05},
                                'tenant': 'h2'},
                               {'action': 'admit',
                                'group': 0,
                                'scores': {'0': 1.5578026666666666e-05,
                                           '1': 1.5578026666666666e-05},
                                'tenant': 'lt'},
                               {'action': 'migrate',
                                'b_rows': 0,
                                'c_rows': 0,
                                'from': 0,
                                'tenant': 'h1',
                                'to': 1},
                               {'action': 'migrate_rollback',
                                'error': 'InjectedFault: injected wave_error '
                                         "at 'fleet_migrate_fail' (hit 1/1)",
                                'from': 1,
                                'tenant': 'h1',
                                'to': 0}],
                    'failed_migrations': 1,
                    'imbalance': 0.38927334717027434,
                    'migrations': 1,
                    'placements': {'h1': 1, 'h2': 0, 'lt': 0},
                    'scores': {'h1': {'0': [3.220096e-05, 47410796],
                                      '1': [3.220096e-05, 47410796]},
                               'h2': {'0': [3.2187306666666665e-05, 47406368],
                                      '1': [3.2187306666666665e-05, 47406368]},
                               'lt': {'0': [1.5578026666666666e-05, 19042432],
                                      '1': [1.5578026666666666e-05,
                                            19042432]}}},
          'straddle': [{'b_routes': [[0, 0, 0, 7056],
                                     [0, 1, 7056, 14112],
                                     [0, 2, 14112, 21168],
                                     [1, 3, 21168, 28224],
                                     [1, 4, 28224, 35280],
                                     [1, 5, 35280, 42336]],
                        'c_routes': [[0, 0, 0, 7056],
                                     [0, 1, 7056, 14112],
                                     [0, 2, 14112, 21168],
                                     [1, 3, 21168, 28224],
                                     [1, 4, 28224, 35280],
                                     [1, 5, 35280, 42336]],
                        'moved': [35280, 35280],
                        'ok': True,
                        'to': 1}],
          'straddle_admitted': {'events': [{'action': 'admit',
                                            'group': 0,
                                            'scores': {'0': 1.8860515555555555e-05,
                                                       '1': 0.0020075776},
                                            'tenant': 'h1'}],
                                'failed_migrations': 0,
                                'imbalance': 2.0,
                                'migrations': 0,
                                'placements': {'h1': 0},
                                'scores': {'h1': {'0': [1.8860515555555555e-05,
                                                        51500552],
                                                  '1': [0.0020075776,
                                                        39973616]}}},
          'straddle_rows': 42336,
          'straddle_state': {'events': [{'action': 'admit',
                                         'group': 0,
                                         'scores': {'0': 1.8860515555555555e-05,
                                                    '1': 0.0020075776},
                                         'tenant': 'h1'},
                                        {'action': 'migrate',
                                         'b_rows': 35280,
                                         'c_rows': 35280,
                                         'from': 0,
                                         'tenant': 'h1',
                                         'to': 1}],
                             'failed_migrations': 0,
                             'imbalance': 2.0,
                             'migrations': 1,
                             'placements': {'h1': 1},
                             'scores': {'h1': {'0': [1.8860515555555555e-05,
                                                     51500552],
                                               '1': [0.0020075776,
                                                     39973616]}}}},
 'quick': {'admitted': {'events': [{'action': 'admit',
                                    'group': 1,
                                    'scores': {'0': 6.925226666666667e-06,
                                               '1': 6.925226666666667e-06},
                                    'tenant': 'h1'},
                                   {'action': 'admit',
                                    'group': 1,
                                    'scores': {'0': 6.914986666666667e-06,
                                               '1': 6.914986666666667e-06},
                                    'tenant': 'h2'},
                                   {'action': 'admit',
                                    'group': 1,
                                    'scores': {'0': 4.75776e-06,
                                               '1': 4.75776e-06},
                                    'tenant': 'lt'}],
                        'failed_migrations': 0,
                        'imbalance': 2.0,
                        'migrations': 0,
                        'placements': {'h1': 1, 'h2': 1, 'lt': 1},
                        'scores': {'h1': {'0': [6.925226666666667e-06, 4817076],
                                          '1': [6.925226666666667e-06,
                                                4817076]},
                                   'h2': {'0': [6.914986666666667e-06, 4808384],
                                          '1': [6.914986666666667e-06,
                                                4808384]},
                                   'lt': {'0': [4.75776e-06, 1242880],
                                          '1': [4.75776e-06, 1242880]}}},
           'moves': [['h1', 0]],
           'rebalance': [{'b_routes': [[0, 0, 0, 1024],
                                       [1, 1, 1024, 2048],
                                       [2, 2, 2048, 3072],
                                       [3, 3, 3072, 4096]],
                          'c_routes': [[0, 0, 0, 1024],
                                       [1, 1, 1024, 2048],
                                       [2, 2, 2048, 3072],
                                       [3, 3, 3072, 4096]],
                          'moved': [0, 0]}],
           'rollback': ['h1', 1, False],
           'state': {'events': [{'action': 'admit',
                                 'group': 1,
                                 'scores': {'0': 6.925226666666667e-06,
                                            '1': 6.925226666666667e-06},
                                 'tenant': 'h1'},
                                {'action': 'admit',
                                 'group': 1,
                                 'scores': {'0': 6.914986666666667e-06,
                                            '1': 6.914986666666667e-06},
                                 'tenant': 'h2'},
                                {'action': 'admit',
                                 'group': 1,
                                 'scores': {'0': 4.75776e-06, '1': 4.75776e-06},
                                 'tenant': 'lt'},
                                {'action': 'migrate',
                                 'b_rows': 0,
                                 'c_rows': 0,
                                 'from': 1,
                                 'tenant': 'h1',
                                 'to': 0},
                                {'action': 'migrate_rollback',
                                 'error': 'InjectedFault: injected wave_error '
                                          "at 'fleet_migrate_fail' (hit 1/1)",
                                 'from': 0,
                                 'tenant': 'h1',
                                 'to': 1}],
                     'failed_migrations': 1,
                     'imbalance': 0.5105416504163894,
                     'migrations': 1,
                     'placements': {'h1': 0, 'h2': 1, 'lt': 1},
                     'scores': {'h1': {'0': [6.925226666666667e-06, 4817076],
                                       '1': [6.925226666666667e-06, 4817076]},
                                'h2': {'0': [6.914986666666667e-06, 4808384],
                                       '1': [6.914986666666667e-06, 4808384]},
                                'lt': {'0': [4.75776e-06, 1242880],
                                       '1': [4.75776e-06, 1242880]}}},
           'straddle': [{'b_routes': [[0, 0, 0, 680],
                                      [0, 1, 680, 1360],
                                      [0, 2, 1360, 2040],
                                      [1, 3, 2040, 2720],
                                      [1, 4, 2720, 3400],
                                      [1, 5, 3400, 4080]],
                         'c_routes': [[0, 0, 0, 680],
                                      [0, 1, 680, 1360],
                                      [0, 2, 1360, 2040],
                                      [1, 3, 2040, 2720],
                                      [1, 4, 2720, 3400],
                                      [1, 5, 3400, 4080]],
                         'moved': [3400, 3400],
                         'ok': True,
                         'to': 1}],
           'straddle_admitted': {'events': [{'action': 'admit',
                                             'group': 0,
                                             'scores': {'0': 5.557617777777777e-06,
                                                        '1': 0.00027594112},
                                             'tenant': 'h1'}],
                                 'failed_migrations': 0,
                                 'imbalance': 2.0,
                                 'migrations': 0,
                                 'placements': {'h1': 0},
                                 'scores': {'h1': {'0': [5.557617777777777e-06,
                                                         5123748],
                                                   '1': [0.00027594112,
                                                         4286084]}}},
           'straddle_rows': 4080,
           'straddle_state': {'events': [{'action': 'admit',
                                          'group': 0,
                                          'scores': {'0': 5.557617777777777e-06,
                                                     '1': 0.00027594112},
                                          'tenant': 'h1'},
                                         {'action': 'migrate',
                                          'b_rows': 3400,
                                          'c_rows': 3400,
                                          'from': 0,
                                          'tenant': 'h1',
                                          'to': 1}],
                              'failed_migrations': 0,
                              'imbalance': 2.0,
                              'migrations': 1,
                              'placements': {'h1': 1},
                              'scores': {'h1': {'0': [5.557617777777777e-06,
                                                      5123748],
                                                '1': [0.00027594112,
                                                      4286084]}}}}}


def slow_tier_rows(plan, L: int):
    """(B rows, C rows) of a flat plan whose ranks sit in different
    groups of L ranks (``HierPlan.inter_group_rows_flat``)."""
    b = c = 0
    for (p, q), pp in plan.pair_plans.items():
        if p // L != q // L:
            b += pp.col_ids.size
            c += pp.row_ids.size
    return b, c


def check_c_rows(c: torch.Tensor, blocks, a, b_host: np.ndarray,
                 what: str) -> float:
    """The rows of C a process holds (``row_blocks``) within 2e-4 of
    scipy's product in float64 (none on an empty span)."""
    import scipy.sparse as sp

    a64 = sp.csr_matrix((a.data.astype(np.float64), a.indices, a.indptr),
                        shape=a.shape)
    b64 = b_host.astype(np.float64)
    ref = np.concatenate([a64[s:e] @ b64 for s, e in blocks]
                         or [np.zeros((0, b64.shape[1]))])
    got = c.double().cpu().numpy()
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: C rows {got.shape} or values bad")
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4, err_msg=what)
    return float(np.abs(got - ref).max()) if got.size else 0.0


def _jsonable(x):
    return json.loads(json.dumps(x, default=list))


def check_pinned(h, want: dict, what: str) -> dict:
    """The handle's decisions (the keys of ``want``) == the pinned
    reference's."""
    st = h.stats()
    got = _jsonable({k: st[k] for k in want if k in st})
    if got != want:
        raise AssertionError(f"{what}: decisions {got} != {want}")
    return got


def mp_times(h, b) -> dict:
    """``h(b)`` median of 7 by CUDA events and host wall, beside each
    call's staging and gloo host seconds (``transport()``)."""
    dev_ms, host_ms, stage_ms, gloo_ms = [], [], [], []
    for _ in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        start.record()
        h(b)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t1) * 1e3)
        dev_ms.append(start.elapsed_time(end))
        tr = h.comm.transport()
        stage_ms.append(tr["stage_s"] * 1e3)
        gloo_ms.append(tr["gloo_s"] * 1e3)
    return {"ms": statistics.median(dev_ms),
            "host_ms": statistics.median(host_ms),
            "stage_ms": statistics.median(stage_ms),
            "gloo_ms": statistics.median(gloo_ms)}


def _path_calls(recorded, path: str):
    """``recorded[path]``: the kernel calls and launches a path gathers
    over its steps, as ``replay_paths`` takes them."""
    return recorded.setdefault(path, [collections.defaultdict(list),
                                      collections.Counter()])


def mp_served(h, b_dev, b_full, a, b_host, what: str, kernels,
              calls=None) -> dict:
    """One counted ``h(b_dev)`` on the fleet, checked: this process's C
    rows ``torch.equal`` to the same rows of the emulated run of the plan
    (``Topology.local(P)`` on the card) and within 2e-4 of float64, rows
    per axis summed over the processes == the emulated log's, rows
    across processes == ``plan_crossing_rows()``; a process whose span
    is empty launches nothing and returns [0, N], and still enters every
    collective. ``calls`` (``_path_calls``) gathers the kernel calls of
    one more ``h(b_dev)`` (where the span holds ranks) and the counted
    run's launches. Returns the call's record and its times."""
    from repro_torch.core.api import materialize_payload
    from repro_torch.distributed.topology import Topology
    from repro_torch.kernels import ops

    lo, hi = h.comm.span
    if calls is not None and lo < hi:
        for k, got in record_kernel_calls(lambda: h(b_dev)).items():
            calls[0][k].extend(got)
    ops.reset_launch_counts()
    c = h(b_dev)
    torch.cuda.synchronize()
    launches = {k: ops.launch_counts()[k] for k in kernels}
    if calls is not None:
        calls[1].update(launches)
    axes = {str(ax): [h.comm.fleet_rows(ax), None]
            for ax in (None, "x", "g", "l")}
    crossing = h.comm.fleet_rows(crossing=True)
    transport = h.comm.transport()
    emu = materialize_payload(h.save_payload(), Topology.local(h.P, h.device))
    c_emu = emu(b_full)
    for ax in axes:
        axes[ax][1] = emu.comm.rows(None if ax == "None" else ax)
    same = torch.equal(c, torch.cat([c_emu[s:e] for s, e in h.row_blocks()]
                                    or [c_emu[:0]]))
    del emu, c_emu
    if not same or any(f != e for f, e in axes.values()) or \
            crossing != h.plan_crossing_rows() or c.device != h.device:
        raise AssertionError(
            f"{what}: C == emulated {same} (on {c.device}); rows (fleet, "
            f"emulated) {axes}; crossing {crossing} vs the plan's "
            f"{h.plan_crossing_rows()}")
    if lo == hi and (any(launches.values())
                     or tuple(c.shape) != (0, b_full.shape[1])):
        raise AssertionError(f"{what}: an empty span launched {launches} "
                             f"and returned {tuple(c.shape)}")
    err = check_c_rows(c, h.row_blocks(), a, b_host, what)
    return dict(span=[lo, hi], row_blocks=h.row_blocks(), rows=axes,
                crossing_rows=crossing, transport=transport,
                max_abs_err=err, launches=launches, **mp_times(h, b_dev))


def _launched(calls, kernels, what: str) -> None:
    missing = [k for k in kernels if calls[1][k] < 1]
    if missing:
        raise AssertionError(f"{what}: {missing} never launched "
                             f"({dict(calls[1])})")


def mp_dispatch(args, topo, recorded) -> dict:
    """Phase 11 (b)'s MoE dispatch across the processes: olmoe-1b-7b's
    ``compile_dispatch(cfg, 1024, 8, where=topo)`` on one prefill's
    tokens at the model's width, then ``dispatch_session`` through
    ``maybe_replan``'s three branches; decisions, returns and events ==
    ``EXPECT_MP_DISPATCH``, every call ``mp_served``. Paths
    ``mp_dispatch`` (the handle) and ``mp_dispatch_session`` (the
    session's handle after the swap)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.moe import (
        compile_dispatch, dispatch_matrix, dispatch_session,
    )

    cfg = (get_smoke_config if args.quick else get_config)(LM_ARCH)
    T, M = DISPATCH["tokens"], DISPATCH["M"]
    expect = EXPECT_MP_DISPATCH["quick" if args.quick else "full"]
    x_host = np.random.default_rng(3).standard_normal((T, cfg.d_model),
                                                      dtype=np.float32)
    x_full = torch.from_numpy(x_host).to(topo.device)  # the emulated run's
    x_dev = topo.put_global(x_host)  # this process's tokens
    a = dispatch_matrix(cfg, T, M)
    t0 = time.perf_counter()
    hd = compile_dispatch(cfg, T, M, where=topo)
    prep_s = time.perf_counter() - t0
    out = {"mp_dispatch": dict(
        mp_served(hd, x_dev, x_full, a, x_host, "mp_dispatch",
                  MP_DISPATCH_KERNELS, _path_calls(recorded, "mp_dispatch")),
        decisions=check_pinned(hd, expect["handle"], "mp_dispatch"),
        prep_s=prep_s, width=cfg.d_model)}
    _launched(recorded["mp_dispatch"], MP_DISPATCH_KERNELS, "mp_dispatch")
    del hd
    t0 = time.perf_counter()
    sess = dispatch_session(cfg, T, M, where=topo)
    check_pinned(sess.handle(), expect["handle"], "mp_dispatch_session")
    prep_s = time.perf_counter() - t0
    drifted = {"drift_ok": a,
               "values_refresh": dataclasses.replace(a, data=a.data * 0.5),
               "drift_replan": dispatch_matrix(cfg, T, M, seed=1)}
    steps = {}
    for name in MP_DISPATCH_DRIFTS:
        t0 = time.perf_counter()
        got = list(sess.maybe_replan(drifted[name]))
        replan_s = time.perf_counter() - t0
        if got != expect[f"replan-{name}"]:
            raise AssertionError(f"mp_dispatch_session: maybe_replan "
                                 f"({name}) returned {got}")
        h = sess.handle()
        last = name == MP_DISPATCH_DRIFTS[-1]
        steps[name] = dict(
            mp_served(h, x_dev, x_full, drifted[name], x_host,
                      f"mp_dispatch_session {name}", MP_DISPATCH_KERNELS,
                      _path_calls(recorded, "mp_dispatch_session")
                      if last else None),
            decisions=check_pinned(h, expect[name],
                                   f"mp_dispatch_session {name}"),
            replan=got, replan_s=replan_s)
    _launched(recorded["mp_dispatch_session"], MP_DISPATCH_KERNELS,
              "mp_dispatch_session")
    events = _jsonable(sess.events)
    if events != expect["events"]:
        raise AssertionError(f"mp_dispatch_session: events {events}")
    out["mp_dispatch_session"] = dict(steps[MP_DISPATCH_DRIFTS[-1]],
                                      steps=steps, events=events,
                                      prep_s=prep_s)
    return out


def rung_inputs(args, mats, b_host, b_full):
    """The rung sessions' matrices and B: the cells' own, or at --quick
    the same generators on 4080 nodes (six ranks need 6 | M)."""
    from repro_torch.core.sparse import power_law_sparse, random_sparse

    m = b_host.shape[0]
    m_r = m - m % 24
    if m_r == m:
        return mats, b_host, b_full
    nnz = (7 * 16_384) // LIFE_SCALE
    return ({"power_law": power_law_sparse(m_r, m_r, nnz, 0.8, seed=0),
             "uniform": random_sparse(m_r, m_r, nnz / m_r ** 2, seed=0)},
            np.ascontiguousarray(b_host[:m_r]), b_full[:m_r])


def mp_rung(args, topo, mats, b_host, b_full, recorded):
    """Phase 11 (b)'s rungs below the fleet: per ``MP_RUNG_CELLS`` a
    session with rungs (4, 6, 8), rung 8, ``on_resize(6)``,
    ``on_resize(4)``, ``adopt_topology(topo.subtopology(slice(2, 6)))``
    and ``on_resize(topo)``; at each step the span table, decisions ==
    ``EXPECT_MP_RUNG`` and ``mp_served``; no MWVC run after the build;
    the events. The path's kernel calls and launches are those of the
    steps below the fleet (``MP_RUNG_PATH_STEPS``). Returns ({cell:
    record}, the power-law session, back on rung 8)."""
    from repro_torch import SpmmConfig
    from repro_torch.core.planner import plan_build_count
    from repro_torch.core.session import SpmmSession

    expect = EXPECT_MP_RUNG["quick" if args.quick else "full"]
    out, sessions = {}, {}
    for what, mat, path, fields in MP_RUNG_CELLS:
        t0 = time.perf_counter()
        sess = SpmmSession.build(mats[mat], topo, SpmmConfig(**fields),
                                 p_ladder=MP_LADDER)
        build_s = time.perf_counter() - t0
        builds = plan_build_count()
        steps = {"p8": sess.handle, "p6": lambda: sess.on_resize(6),
                 "p4": lambda: sess.on_resize(4),
                 "group26": lambda: sess.adopt_topology(
                     topo.subtopology(slice(2, 6))),
                 "back8": lambda: sess.on_resize(topo)}
        got = {}
        for step, switch in steps.items():
            t0 = time.perf_counter()
            h = switch()
            switch_s = time.perf_counter() - t0
            spans = [list(s) for s in h.topology.spans]
            if spans != MP_RUNG_SPANS[step]:
                raise AssertionError(f"{what} {step}: spans {spans}")
            got[step] = dict(
                mp_served(h, h.topology.put_global(b_host), b_full,
                          mats[mat], b_host, f"{what} {step}",
                          MP_KERNELS[mat], _path_calls(recorded, path)
                          if step in MP_RUNG_PATH_STEPS else None),
                decisions=check_pinned(h, expect[what][step],
                                       f"{what} {step}"),
                P=h.P, spans=spans, switch_s=switch_s)
        if plan_build_count() != builds:
            raise AssertionError(f"{what}: a resize re-ran MWVC")
        _launched(recorded[path], MP_KERNELS[mat], path)
        events = _jsonable(sess.events)
        adopted = [e.pop("topology") for e in events
                   if e["action"] == "adopt_topology"]
        if events != expect[what]["events"] or adopted != [dict(
                topo.subtopology(slice(2, 6)).describe(), group=[2, 6])]:
            raise AssertionError(f"{what}: events {events}, {adopted}")
        out[what] = {"build_s": build_s, "steps": got, "events": events}
        sessions[mat] = sess
    return out, sessions["power_law"]


def mp_degrade(sess, a, b_host, b_full) -> dict:
    """Phase 11 (b)'s degrade: a ``SpmmWaveServer`` over the power-law
    rung session (on rung 8) whose first wave fails twice on every
    process (``wave_error``, ``times=2``): both degrade 8 -> 6 and serve
    the wave there, every output == the emulated rung 6's."""
    from repro_torch.core.api import materialize_payload
    from repro_torch.distributed.topology import Topology
    from repro_torch.robustness.faults import Fault, inject
    from repro_torch.serving.scheduler import SpmmRequest, SpmmWaveServer

    if sess.current_P != P:
        raise AssertionError(f"mp_degrade: the session is on rung "
                             f"{sess.current_P}")
    server = SpmmWaveServer(sess, max_batch=2, max_retries=2, backoff=0.0)
    reqs = [SpmmRequest(i, b_host) for i in range(4)]
    for req in reqs:
        server.submit(req)
    with inject([Fault(kind="wave_error", site="wave", times=2)]) as plan:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = server.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    events = [e for e in server.events if e["action"] != "wave_failed"]
    h = sess.handle()
    if events != [{"action": "degrade", "from": P, "to": 6}] or \
            plan.fired("wave_error") != 2 or stats.dropped_waves or \
            stats.served != len(reqs) or sess.current_P != 6:
        raise AssertionError(f"mp_degrade: events {events}, {stats}")
    emu = materialize_payload(h.save_payload(), Topology.local(h.P, h.device))
    c_emu = emu(b_full)
    want = torch.cat([c_emu[s:e] for s, e in h.row_blocks()])
    if not all(torch.equal(req.output, want) for req in reqs):
        raise AssertionError("mp_degrade: an output != the emulated rung's")
    return {"events": events, "stats": dataclasses.asdict(stats),
            "run_s": run_s, "ms_per_request": run_s * 1e3 / len(reqs),
            "span": list(h.comm.span), "max_abs_err": check_c_rows(
                reqs[0].output, h.row_blocks(), a, b_host, "mp_degrade")}


def _fleet_state(fleet) -> dict:
    """A fleet's host-side decisions and counters, as the pins hold them."""
    return _jsonable({"placements": fleet.placements(),
                      "scores": {n: {g: list(v) for g, v in t.scores.items()}
                                 for n, t in fleet.tenants.items()},
                      "imbalance": fleet.imbalance(),
                      "migrations": fleet.migrations,
                      "failed_migrations": fleet.failed_migrations,
                      "events": fleet.events})


def _fleet_routes(old, new) -> dict:
    """A migration's B / C reshard routes and moved rows."""
    from repro_torch import ReshardSpec
    from repro_torch.core.sparse import block_rows

    b = ReshardSpec.between(block_rows(old.shape[1], old.P),
                            block_rows(new.shape[1], new.P))
    c = ReshardSpec.between(tuple(old.bounds), tuple(new.bounds))
    return {"b_routes": [list(r) for r in b.routes],
            "c_routes": [list(r) for r in c.routes],
            "moved": [b.moved_rows(), c.moved_rows()]}


def mp_fleet(args, topo, mats, b_host, b_full, recorded) -> dict:
    """Phase 11 (b)'s ``SpmmFleet`` on the groups of the process fleet:
    phase 9's three tenants on ``SpmmFleet(topo, (4, 4))`` (group 0 on
    worker 0, group 1 on worker 1): a served round, ``rebalance()`` (a
    migration across the boundary), a served round, a migration that a
    fault on worker 1 alone rolls back on both; then h1 with rungs (2, 6)
    on ``(2, 6)``, served, migrated into group 1 (ranks [2, 8), across
    the boundary) and served. Decisions, routes, moved rows and events ==
    ``EXPECT_MP_FLEET``; every served C's rows ``torch.equal`` to the
    emulated run of its plan and within 2e-4 of float64; the resident
    slabs after each migration == the served rows under the new
    partition; no wave dropped. Path ``mp_fleet``: the served rounds'
    kernel calls and launches."""
    from repro_torch import SpmmConfig, SpmmFleet
    from repro_torch.core.api import materialize_payload
    from repro_torch.core.planner import plan_build_count
    from repro_torch.core.sparse import block_rows, power_law_sparse
    from repro_torch.distributed.topology import Topology
    from repro_torch.kernels import ops
    from repro_torch.robustness import Fault, inject

    me, dev = topo.process_index, topo.device
    expect = EXPECT_MP_FLEET["quick" if args.quick else "full"]
    m = b_host.shape[0]
    nnz = (7 * 16_384 if args.quick else NNZ_FULL) // LIFE_SCALE
    lt = FLEET_LIGHT_QUICK if args.quick else FLEET_LIGHT
    a = {"h1": mats["power_law"],
         "h2": power_law_sparse(m, m, nnz, 0.8, seed=FLEET_H2_SEED),
         "lt": power_law_sparse(lt["m"], lt["m"], lt["nnz"], 0.8,
                                seed=lt["seed"])}
    lt_host = np.random.default_rng(9).standard_normal(
        (lt["m"], N_COLS)).astype(np.float32)
    bs = {"h1": (b_full, b_host), "h2": (b_full, b_host),
          "lt": (torch.from_numpy(lt_host).to(dev), lt_host)}
    cfg = SpmmConfig(n_dense_hint=N_COLS)
    calls = _path_calls(recorded, "mp_fleet")
    served_c = {}  # tenant -> the whole C of its last served round
    out = {"rounds": [], "checks": []}

    def check(what, got, want):
        if got != want:
            raise AssertionError(f"mp_fleet {what}: {got} != the "
                                 f"reference's {want}")
        out["checks"].append(what)

    def serve(fleet, what):
        # the path's kernel row is one round's, its calls and its launches
        # both: the first round in which this worker launches (worker 1
        # holds no rank of group 0, where the three tenants are admitted)
        record = not any(calls[1].values())
        for n in fleet.tenants:
            fleet.submit(n, bs[n][0][:a[n].shape[1]])
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if record:
            done = {}
            got = record_kernel_calls(lambda: done.update(fleet.serve()))
        else:
            done = fleet.serve()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = {k: ops.launch_counts()[k] for k in MP_DISPATCH_KERNELS}
        if record and any(launches.values()):
            for k, c in got.items():
                calls[0][k].extend(c)
            calls[1].update(launches)
        rec = {"what": what, "wall_ms": wall,
               "per_request_ms": wall / len(done), "launches": launches,
               "tenants": {}}
        gloo = 0.0
        for n, (c,) in done.items():
            h = fleet.tenants[n].session.handle()
            tr = h.comm.transport()
            gloo += tr["gloo_s"] * 1e3
            emu = materialize_payload(h.save_payload(),
                                      Topology.local(h.P, dev))
            c_emu = emu(bs[n][0][:a[n].shape[1]])
            rows = h.row_blocks()
            if not torch.equal(c, torch.cat([c_emu[s_:e_] for s_, e_ in rows]
                                             or [c_emu[:0]])):
                raise AssertionError(f"mp_fleet {what} {n}: C != the "
                                     f"emulated run's")
            served_c[n] = c_emu
            rec["tenants"][n] = {
                "P": h.P, "group": fleet.placements()[n], "rows": rows,
                "max_abs_err": check_c_rows(c, rows, a[n],
                                            bs[n][1][:a[n].shape[1]],
                                            f"mp_fleet {what} {n}"),
                "gloo_ms": tr["gloo_s"] * 1e3,
                "exchanges": tr["exchanges"]}
            del emu
        rec["gloo_ms"] = gloo
        out["rounds"].append(rec)
        return rec

    def residents(fleet, n, what):
        """The tenant's resident slabs == the served rows, new partition."""
        t = fleet.tenants[n]
        h = t.session.handle()
        lo, hi = h.topology.span
        b = bs[n][0][:a[n].shape[1]]
        ok = (len(t.resident_b) == len(t.resident_c) == hi - lo
              and all(torch.equal(r, b[x:y]) for r, (x, y) in zip(
                  t.resident_b, block_rows(h.plan.shape[1], h.P)[lo:hi]))
              and all(torch.equal(r, served_c[n][x:y]) for r, (x, y) in zip(
                  t.resident_c, list(h.plan.bounds)[lo:hi])))
        if not ok:
            raise AssertionError(f"mp_fleet {what}: resident slabs of {n} "
                                 f"!= the served rows")
        return dict(fleet.reshards[-1], span=[lo, hi])

    t0 = time.perf_counter()
    fleet = SpmmFleet(topo, MP_FLEET_SPLIT, config=cfg)
    for n in MP_FLEET_ORDER:
        fleet.admit(n, a[n])
    out["admit_s"] = time.perf_counter() - t0
    check("admitted", _fleet_state(fleet), expect["admitted"])
    serve(fleet, "admitted")
    old = {n: t.session.handle().plan for n, t in fleet.tenants.items()}
    n0 = plan_build_count()
    moves, _, out["rebalance_ms"] = _timed(fleet.rebalance)
    moves = [list(mv) for mv in moves]
    check("moves", moves, expect["moves"])
    if plan_build_count() != n0:
        raise AssertionError("mp_fleet: rebalance ran MWVC")
    check("rebalance routes", [_fleet_routes(
        old[n], fleet.tenants[n].session.handle().plan) for n, _ in moves],
        expect["rebalance"])
    out["rebalance"] = [residents(fleet, n, "rebalance") for n, _ in moves]
    serve(fleet, "rebalanced")
    name = moves[0][0]
    src = fleet.placements()[name]
    faults = [Fault(kind="wave_error", site="fleet_migrate_fail")] \
        if me == MP_FLEET_FAULT_WORKER else []
    with inject(faults) as fp:
        ok, _, out["rollback_ms"] = _timed(
            lambda: fleet.migrate(name, 1 - src))
    if ok or fp.fired("wave_error") != int(me == MP_FLEET_FAULT_WORKER):
        raise AssertionError(f"mp_fleet: the fault on worker "
                             f"{MP_FLEET_FAULT_WORKER} did not roll the "
                             f"migration back here")
    check("rollback", [name, 1 - src, ok], expect["rollback"])
    check("state", _fleet_state(fleet), expect["state"])
    # a migration into the group that straddles the processes
    m26 = m - m % 24
    a26 = a["h1"] if m26 == m else power_law_sparse(m26, m26, nnz, 0.8,
                                                    seed=0)
    a["h1"] = a26
    f26 = SpmmFleet(topo, MP_FLEET_STRADDLE, config=cfg)
    f26.admit("h1", a26, p_ladder=MP_FLEET_LADDER)
    check("straddle admitted", _fleet_state(f26), expect["straddle_admitted"])
    serve(f26, "straddle")
    out["straddle"] = []
    for dst in ((1,) if f26.placements()["h1"] == 0 else (0, 1)):
        old26 = f26.tenants["h1"].session.handle().plan
        ok, _, ms = _timed(lambda: f26.migrate("h1", dst))
        step = dict(to=dst, ok=ok, **_fleet_routes(
            old26, f26.tenants["h1"].session.handle().plan))
        check(f"straddle to {dst}", step,
              expect["straddle"][len(out["straddle"])])
        out["straddle"].append(dict(residents(f26, "h1", f"straddle {dst}"),
                                    migrate_ms=ms))
        serve(f26, f"straddle at group {dst}")
    check("straddle state", _fleet_state(f26), expect["straddle_state"])
    dropped = [t.server.stats.dropped_waves for fl in (fleet, f26)
               for t in fl.tenants.values()]
    if any(dropped):
        raise AssertionError(f"mp_fleet: dropped waves {dropped}")
    _launched(calls, MP_DISPATCH_KERNELS, "mp_fleet")
    out["span"] = list(topo.span)
    del fleet, f26, served_c
    return out


def mp_worker(args) -> None:
    """One process of phase 11 (b): its span of the P = 8 ranks on the
    card. Writes ``<dir>/rank<i>.json`` for the parent; any failed check
    raises, and the process exits non-zero."""
    import torch.distributed as dist

    from repro_torch import SpmmConfig, compile_spmm
    from repro_torch.core.api import _tensor_leaves
    from repro_torch.core.sparse import power_law_sparse, random_sparse
    from repro_torch.launch.multiprocess import initialize, shutdown

    topo = initialize(timeout=MP_TIMEOUT)
    me, (lo, hi) = topo.process_index, topo.span
    if topo.device.type != MP_DEVICE or topo.tiers != (MP_NPROC, MP_LOCAL):
        raise AssertionError(f"worker {me}: topology {topo}")
    torch.backends.cuda.matmul.allow_tf32 = False
    # on a quarter of arxiv (LIFE_SCALE, as phases 8, 9 and 12: the same
    # generators and seeds; cut to keep the script in its time limit)
    m = (16_384 if args.quick else M_FULL) // LIFE_SCALE
    nnz = (7 * 16_384 if args.quick else NNZ_FULL) // LIFE_SCALE
    b_host = np.random.default_rng(0).standard_normal((m, N_COLS),
                                                      dtype=np.float32)
    b_full = torch.from_numpy(b_host).to(topo.device)  # the emulated run's
    b_dev = topo.put_global(b_host)  # this process's rows only
    mats = {"power_law": power_law_sparse(m, m, nnz, 0.8, seed=0),
            "uniform": random_sparse(m, m, nnz / m ** 2, seed=0)}
    expect = EXPECT_MP["quick" if args.quick else "full"]
    out = {"process": me, "span": [lo, hi], "device": str(topo.device),
           "topology": topo.describe(), "cells": {}}
    recorded = {}
    for what, mat, path, fields in MP_CELLS:
        t0 = time.perf_counter()
        a = mats[mat]
        h = compile_spmm(a, topo, SpmmConfig(**fields))
        prep_s = time.perf_counter() - t0
        log(f"[worker {me}] {what}: compile_spmm {prep_s:.1f} s: {h}")
        st = h.stats()
        want = expect[what]
        got = {k: st.get(k) for k in want if k in st}
        got["crossing_padded"] = h.plan_crossing_rows()
        got["slow_tier_rows"] = (tuple(h.hier.inter_group_rows())
                                 if h.hier is not None
                                 else slow_tier_rows(h.plan, MP_LOCAL))
        got["slow_tier_rows_flat_plan"] = slow_tier_rows(h.plan, MP_LOCAL)
        if got != want:
            raise AssertionError(f"worker {me} {what}: decisions {got} != "
                                 f"{want}")
        if any(t.device != topo.device for _, t in _tensor_leaves(h.ex)):
            raise AssertionError(f"{what}: exec arrays off the card")
        cell = mp_served(h, b_dev, b_full, a, b_host, what, MP_KERNELS[mat],
                         _path_calls(recorded, path))
        _launched(recorded[path], MP_KERNELS[mat], what)
        vol_axis = "g" if h.strategy == "hier" else "None"
        if cell["rows"][vol_axis][0] != st["volume_rows_padded"]:
            raise AssertionError(
                f"worker {me} {what}: rows (fleet, emulated) "
                f"{cell['rows']} vs volume_rows_padded "
                f"{st['volume_rows_padded']}")
        log(f"[worker {me}] {what}: checked at "
            f"{time.perf_counter() - t0:.1f} s")
        out["cells"][what] = dict(
            cell, prep_s=prep_s,
            decisions={k: list(v) if isinstance(v, tuple) else v
                       for k, v in got.items()},
            crossing_bytes=cell["crossing_rows"] * N_COLS * 4)
    del h
    # the MoE dispatch, the rungs below the fleet, the wave server's
    # degrade
    t0 = time.perf_counter()
    out.update(mp_dispatch(args, topo, recorded))
    log(f"[worker {me}] mp_dispatch: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fleet_in = (mats, b_host, b_full)  # the cells' own, for mp_fleet
    mats, b_host, b_full = rung_inputs(args, mats, b_host, b_full)
    out["rungs"], sess = mp_rung(args, topo, mats, b_host, b_full, recorded)
    log(f"[worker {me}] mp_rung: {time.perf_counter() - t0:.1f} s")
    out["degrade"] = mp_degrade(sess, mats["power_law"], b_host, b_full)
    del sess, b_full
    t0 = time.perf_counter()
    out["mp_fleet"] = mp_fleet(args, topo, *fleet_in, recorded)
    out["mp_fleet"]["seconds"] = time.perf_counter() - t0
    log(f"[worker {me}] mp_fleet: {out['mp_fleet']['seconds']:.1f} s")
    del fleet_in
    torch.cuda.empty_cache()
    # every recorded kernel call against its plain version, one process
    # at a time (both share the card, and the replays are timed)
    rows = {}
    for turn in range(topo.n_hosts):
        if turn == me:
            t0 = time.perf_counter()
            rows = replay_paths({
                k: {path: recorded[path]
                    for path, ks in MP_PATH_KERNELS.items() if k in ks}
                for k in ("gather_rows", "gather_rows_scaled",
                          "scatter_add_rows", "bsr_spmm", "bsr_spmm_acc")})
            log(f"[worker {me}] kernel calls replayed in "
                f"{time.perf_counter() - t0:.1f} s")
        dist.barrier()
    out["kernels"] = rows
    with open(os.path.join(args.mp_worker, f"rank{me}.json"), "w") as f:
        json.dump(out, f)
    shutdown()


def _served_line(rec, label: str, card: str) -> None:
    share = lambda x: x / rec["host_ms"] if rec["host_ms"] else 0.0  # noqa: E731,E501
    log(f"  {label} rows {rec['row_blocks']}: C == emulated; max abs err "
        f"vs float64 {rec['max_abs_err']:.3g} (tol 2e-4); launches "
        f"{rec['launches']}; h(b) [{card}] median of 7: {rec['ms']:.3f} ms "
        f"device events, {rec['host_ms']:.3f} ms host wall; staging "
        f"{rec['stage_ms']:.3f} ms ({share(rec['stage_ms']):.1%}), gloo "
        f"{rec['gloo_ms']:.3f} ms ({share(rec['gloo_ms']):.1%}); "
        f"{rec['transport']['exchanges']} exchanges, "
        f"{rec['transport']['staged_bytes']} B staged")


def mp_session_log(res, card: str) -> None:
    """Phase 11 (b)'s dispatch, rungs and degrade, each worker's."""
    for path in ("mp_dispatch", "mp_dispatch_session"):
        d = res[0][path]
        log(f"{path} (width {res[0]['mp_dispatch']['width']}, prep "
            f"{d['prep_s']:.2f} s) decisions: {json.dumps(d['decisions'])}")
        log(f"  rows (fleet, emulated) by axis {json.dumps(d['rows'])}; "
            f"across processes {d['crossing_rows']} rows")
        for r in res:
            _served_line(r[path], f"worker {r['process']}", card)
    d = res[0]["mp_dispatch_session"]
    for name, st in d["steps"].items():
        log(f"  maybe_replan ({name}) -> {st['replan']} in "
            f"{st['replan_s']:.2f} s; volume_rows_padded "
            f"{st['decisions']['volume_rows_padded']}; worker errors "
            f"{[r['mp_dispatch_session']['steps'][name]['max_abs_err'] for r in res]}")  # noqa: E501
    log(f"  events (== the reference's): {json.dumps(d['events'])}")
    for what, cell in res[0]["rungs"].items():
        log(f"{what} rungs {MP_LADDER}: session build {cell['build_s']:.1f}"
            f" s; events (== the reference's) {json.dumps(cell['events'])}")
        for step in MP_RUNG_SPANS:
            st = cell["steps"][step]
            log(f"  {step}: P={st['P']}, spans {st['spans']}, switch "
                f"{st['switch_s']:.2f} s, decisions "
                f"{json.dumps(st['decisions'])}; rows (fleet, emulated) "
                f"{json.dumps(st['rows'])}; across {st['crossing_rows']}")
            for r in res:
                _served_line(r["rungs"][what]["steps"][step],
                             f"{step} worker {r['process']}", card)
    for r in res:
        d = r["degrade"]
        log(f"mp_degrade worker {r['process']}: {json.dumps(d['events'])}; "
            f"{json.dumps(d['stats'])}; span {d['span']} on rung 6; "
            f"run() {d['run_s']:.3f} s host wall, {d['ms_per_request']:.3f}"
            f" ms a request; max abs err {d['max_abs_err']:.3g}")


def mp_fleet_log(res, card: str) -> None:
    """Phase 11 (b)'s mp_fleet, each worker's."""
    f = res[0]["mp_fleet"]
    log(f"mp_fleet: decisions, routes, moved rows and events == the "
        f"reference's ({', '.join(f['checks'])}); admitted in "
        f"{f['admit_s']:.1f} s; worker spans {[r['span'] for r in res]}")
    for r in res:
        x = r["mp_fleet"]
        for rb in x["rebalance"] + x["straddle"]:
            log(f"  worker {r['process']} migrate {rb['tenant']} "
                f"{rb['from']} -> {rb['to']} (span here {rb['span']}): "
                f"moved rows (B, C) {rb['b_rows']}, {rb['c_rows']} "
                f"(ReshardSpec.moved_rows), across processes "
                f"{rb['b_rows_crossing']}, {rb['c_rows_crossing']} rows = "
                f"{rb['bytes_crossing']} B; resident slabs == the served "
                f"rows" + (f"; {rb['migrate_ms']:.1f} ms host wall"
                           if "migrate_ms" in rb else ""))
        log(f"  worker {r['process']}: rebalance {x['rebalance_ms']:.1f} ms"
            f", rolled-back migrate {x['rollback_ms']:.1f} ms host wall; "
            f"seconds {x['seconds']:.1f}")
        for rd in x["rounds"]:
            log(f"  worker {r['process']} served round ({rd['what']}) "
                f"[{card}]: {len(rd['tenants'])} requests in "
                f"{rd['wall_ms']:.3f} ms host wall, {rd['per_request_ms']:.3f}"
                f" ms a request; gloo {rd['gloo_ms']:.3f} ms "
                f"({rd['gloo_ms'] / rd['wall_ms']:.1%}); launches "
                f"{json.dumps(rd['launches'])}; per tenant (P, group, rows, "
                f"max abs err vs float64, gloo ms) "
                f"{[(n, t['P'], t['group'], t['rows'], round(t['max_abs_err'], 7), round(t['gloo_ms'], 3)) for n, t in rd['tenants'].items()]}")  # noqa: E501


def _launchers(runs):
    """``python -m repro_torch.launch.multiprocess`` on the card once per
    ``(flags, faults)`` of ``runs``, all at once, each waited for at most
    ``MP_TIMEOUT`` seconds; their outputs are logged in turn. Returns
    (stdout, seconds) per run; a launcher that fails raises."""
    import tempfile

    started = []
    for flags, faults in runs:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        env.pop("REPRO_FAULTS_EPOCH", None)
        if faults is not None:
            env["REPRO_FAULTS"] = json.dumps(faults)
        out = tempfile.TemporaryFile("w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.multiprocess",
             "--nproc", str(MP_NPROC), "--local-devices", str(MP_LOCAL),
             "--device", MP_DEVICE, "--timeout", str(MP_TIMEOUT), *flags],
            env=env, stdout=out, stderr=subprocess.STDOUT, text=True)
        started.append((flags, proc, out, time.perf_counter()))
    deadline = time.perf_counter() + MP_TIMEOUT + 30
    results, failed = [], []
    for flags, proc, out, t0 in started:
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "killed at the deadline"
        secs = time.perf_counter() - t0
        out.seek(0)
        text = out.read()
        out.close()
        log(f"launcher {' '.join(flags) or '(no flags)'}:")
        for line in text.splitlines():
            if "hostname of the client socket" not in line:
                log(f"  | {line}")
        if rc != 0:
            failed.append((flags, rc))
        results.append((text, secs))
    if failed:
        raise AssertionError(f"launchers failed: {failed}")
    return results


def mp_phase(args, card: str) -> dict:
    """Phase 11: (a) the reference's smoke across 2 processes × 4 ranks on
    the card and (c) the supervisor's kill and degrade drills, the three
    launchers side by side; then (b) the three mp-* handles at arxiv
    scale in 2 workers (``mp_worker``), each process's C rows == the
    emulated run's and within 2e-4 of float64, decisions ==
    ``EXPECT_MP``, rows per axis == the emulated log's, rows across
    processes == the plan's. Returns the kernel rows of the mp_* paths
    (worker 0's numbers, the worst error of both)."""
    import shutil

    from repro_torch.launch.multiprocess import launch_local

    t_phase = time.perf_counter()
    # (a) and (c), all at once, before (b)'s timed calls
    kill = {"kind": "worker_kill", "site": "stage:serve", "rank": 1,
            "epoch": 0}
    (smoke, secs_a), (killed, secs_k), (degraded, secs_d) = _launchers([
        ((), None), (("--supervise", "--backoff", "0"), [kill]),
        (("--supervise", "--max-restarts", "0", "--backoff", "0"),
         [dict(kill, epoch=e) for e in range(3)])])
    if f"multiprocess smoke: {MP_NPROC} processes x {MP_LOCAL} ranks on " \
            f"{MP_DEVICE}  OK" not in smoke or \
            smoke.count("replan hot-swap OK") != MP_NPROC:
        raise AssertionError("mp (a): the smoke did not report OK")
    log(f"mp (a): smoke across {MP_NPROC} processes x {MP_LOCAL} ranks on "
        f"the card in {secs_a:.1f} s")
    if f"recovered after 1 restart(s) (nproc={MP_NPROC})" not in killed:
        raise AssertionError("mp (c): the kill drill did not recover")
    log(f"mp (c): kill drill recovered after 1 restart in {secs_k:.1f} s")
    rung = f"surviving rung P={(MP_NPROC - 1) * MP_LOCAL} of ladder"
    if "recovered DEGRADED" not in degraded or rung not in degraded:
        raise AssertionError("mp (c): the degrade drill did not serve the "
                             "surviving rung")
    log(f"mp (c): degrade drill served rung {(MP_NPROC - 1) * MP_LOCAL} "
        f"in {secs_d:.1f} s (the three launchers ran side by side)")

    # (b)
    out_dir = os.path.join(ROOT, "build", "mp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    rc = launch_local(MP_NPROC, MP_LOCAL, timeout=MP_TIMEOUT, device=MP_DEVICE,
                      argv=[sys.executable, os.path.abspath(__file__),
                            "--mp-worker", out_dir]
                      + (["--quick"] if args.quick else []))
    if rc:
        raise AssertionError(f"mp (b): a worker failed (exit {rc})")
    res = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
           for r in range(MP_NPROC)]
    shutil.rmtree(out_dir, ignore_errors=True)
    log(f"mp (b): {MP_NPROC} workers in {time.perf_counter() - t0:.1f} s, "
        f"devices {[r['device'] for r in res]}, spans "
        f"{[r['span'] for r in res]}")
    for what, _, path, _ in MP_CELLS:
        cells = [r["cells"][what] for r in res]
        d = cells[0]
        log(f"{what} decisions: {json.dumps(d['decisions'])}")
        log(f"  rows (fleet, emulated) by axis {json.dumps(d['rows'])}; "
            f"across processes {d['crossing_rows']} rows = "
            f"{d['crossing_bytes']} B (plan: {d['decisions']['crossing_padded']}"
            f" padded; slow tier {d['decisions']['slow_tier_rows']}, flat "
            f"plan {d['decisions']['slow_tier_rows_flat_plan']} unpadded)")
        for r, cell in zip(res, cells):
            log(f"  worker {r['process']} rows {cell['row_blocks']}: C == "
                f"emulated; max abs err vs scipy float64 "
                f"{cell['max_abs_err']:.3g} (tol 2e-4); prep "
                f"{cell['prep_s']:.1f} s; launches {cell['launches']}")
            log(f"  h(b) {what} worker {r['process']} [{card}]: median of 7:"
                f" {cell['ms']:.3f} ms device events, {cell['host_ms']:.3f}"
                f" ms host wall; staging {cell['stage_ms']:.3f} ms "
                f"({cell['stage_ms'] / cell['host_ms']:.1%}), gloo "
                f"{cell['gloo_ms']:.3f} ms "
                f"({cell['gloo_ms'] / cell['host_ms']:.1%}); "
                f"{cell['transport']['exchanges']} exchanges, "
                f"{cell['transport']['staged_bytes']} B staged")
    mp_session_log(res, card)
    mp_fleet_log(res, card)
    rows = {}
    for k, per_path in res[0]["kernels"].items():
        for path, row in per_path.items():
            other = [r["kernels"][k][path] for r in res[1:]]
            row = dict(row, max_abs_err=max(
                [row["max_abs_err"]] + [o["max_abs_err"] for o in other]),
                launches_per_worker=[row["launches"]]
                + [o["launches"] for o in other])
            rows.setdefault(k, {})[path] = row

    log(f"phase 11 multiprocess: {time.perf_counter() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 12: SHIRO training and the expert-parallel LM across two processes
# ---------------------------------------------------------------------------

MP_EPOCHS = {"gcn": 5, "gat": 3}  # cut from phase 5d's 200 / 50: see PERF.md
# (what, graph, model, kernel path, config fields): the training handles
# every worker compiles on the fleet (coo: a bsr SpMM takes no gradient)
MP_TRAIN_CELLS = (
    ("mp-gcn-train-arxiv flat", "power_law", "gcn", "mp_gcn_step", {}),
    ("mp-gcn-train-arxiv hier", "power_law", "gcn", None,
     dict(hier="auto")),
    ("mp-gat-train-arxiv", "uniform", "gat", "mp_gat_step",
     dict(kernel="fused", edge="leaky_relu")),
)
# the model axis crosses the process boundary: process i holds model
# ranks 4i .. 4i + 3 of the one data group
MP_EP_GRID = ((1, 8), ("data", "model"))
# the EP LM's layers there: cut from OLMoE-1B-7B's 16, to keep the script
# inside its limit beside the LM train cell's checkpoints
MP_EP_LAYERS = 4
# the LM train step on the fleet: OLMoE-1B-7B at its published width cut
# to 1 layer (two processes that each hold every whole leaf share the
# card: ~16 GB a process with AdamW's float32 moments, old and new), one
# SyntheticLM batch (seed 0), 3 steps of each case on 2 processes x 4
# ranks; (path, grid, MoE): "dense" swaps the MoE for a SwiGLU MLP of the
# config's d_ff, the EP cases run _moe_ep at the published capacity
MP_LM_TRAIN = dict(layers=1, batch=8, seq=128, steps=3)
MP_LM_CASES = (("mp_lm_train_dense", (2, 4), False),
               ("mp_lm_train_ep", (2, 4), True),
               ("mp_lm_train_ep_cross", (1, 8), True))
MP_LM_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=3,
                 schedule="constant", grad_clip=1.0)
# the case that runs through Trainer.fit: a checkpoint every 2
# steps (2 and 3, the last the final save), the unsharded tree written by
# worker 0 under the phase's directory; step 3 deleted and a second fit
# resumed from 2; the phase's process restores step 2 onto one device
# and onto the emulated (1, 8) grid
MP_LM_TRAINER = "mp_lm_train_ep_cross"
MP_LM_CKPT_EVERY = 2
# the fleet vs its emulated twin in bf16 where the fleet's sums cannot
# follow the emulated order (two data groups: each group's weight
# gradients are products over its own rows, folded after): relative loss
# and grad norm; the parameters' absolute error: an AdamW step moves a
# weight by at most ~2·lr here, so two runs whose gradients round apart
# end at most 3 steps × 2 × 2·lr = 3.6e-3 apart, plus one bf16 ulp of the
# largest weights (9.8e-4 below 0.25)
MP_LM_TWIN_TOL = dict(loss=1e-3, grad_norm=1e-2, param=5e-3)
# a (pod 2, data 2, model 2) grid in the same 2 x 4 workers (mp_pod): one
# pod a worker, the batch over (pod, data) flattened; OLMoE-1B-7B at its
# published width cut to 1 layer (--quick: olmoe-smoke), one 8 x 128
# prefill and one decode step against the emulated grid, and a float32
# copy's forward and decode within 2e-4
MP_POD_GRID = ((2, 2, 2), ("pod", "data", "model"))
MP_POD = dict(layers=1, batch=8, seq=128)
# a ragged grid in a second launch of 2 processes x 3 ranks
# (mp_ragged_train): (data 3, model 2), process 0 runs group 0 and model
# rank 0 of group 1, process 1 the rest, so each holds both model ranks'
# experts and group 1 is split between them; phase 12's LM train config,
# a 6 x 128 SyntheticLM batch, 3 steps against the emulated twin within
# MP_LM_TWIN_TOL, and a float32 copy's forward and decode within 2e-4
MP_RAGGED = dict(nproc=2, local=3, grid=(3, 2), batch=6, seq=128, steps=3)
# the hybrid, encdec, vlm and audio families on the fleet's grid after the
# LM cases, at their published widths cut in depth, each released before
# the next: (path, arch, config changes, tokens a prompt). zamba2: its
# first group (attn_every Mamba2 layers, then the shared block); seamless:
# 1 + 1 layers over its 1024 frames; llava: 1 layer, 448 tokens after its
# 576 patches (1024 positions); audio: llava's path with the audio
# frontend, as the CPU tests build it. Each runs forward, one decode step
# and MP_FAMILY["steps"] make_train_step steps on every grid of
# MP_FAMILY_GRIDS, against an emulated twin in the phase's process
MP_FAMILY_CASES = (
    ("mp_family_hybrid", "zamba2-2.7b", {}, 128),
    ("mp_family_encdec", "seamless-m4t-medium",
     dict(n_layers=1, n_enc_layers=1), 128),
    ("mp_family_vlm", "llava-next-mistral-7b", dict(n_layers=1), 448),
    ("mp_family_audio", "llava-next-mistral-7b",
     dict(n_layers=1, family="audio", frontend="audio"), 448))
MP_FAMILY_GRIDS = ((1, 8), (2, 4))
MP_FAMILY = dict(batch=8, steps=2, max_len=16)
# (data 2, model 4): each process's forward and decode products run over
# its own rows in bf16, the emulated grid's over both groups' at once; the
# last position's logits held to this share of their largest magnitude (a
# few bf16 roundings, 2^-8 each, through the cut model); the train steps
# to MP_LM_TWIN_TOL, but for the second step's grad norm: after one AdamW
# step, which turns the folded gradient's last-bit differences into whole
# ±lr moves of small entries, zamba2's group's second grad norm moves ~6%
# (PERF.md §6). The fold itself is held instead: the first step's folded
# gradient against the twin's, leaf by leaf
MP_FAMILY_ROWS_TOL = 2e-2
# ||fleet - twin|| / ||twin|| of each leaf of that first-step gradient:
# bf16's sums over two data groups read up to 1.0e-2 on an H100 (seamless's
# encoder wq, PERF.md §6), a fold that drops or doubles one group's half
# of the batch ~0.5 and more; the limit sits between, 5x the reading
MP_FAMILY_GRAD_TOL = 5e-2
# the reference's decisions for the training handles with the fleet's
# derived NetworkSpec (derived-gpu-2x4: 450 / 25 GB/s, group 4) and tiers
# (2, 4), on phase 12's quarter of arxiv (``life_matrices``' size):
# scripts/reference_fleet_pins.py (the JAX package's _plan_and_tune,
# CPU run; with --scale 1 it reproduces the full-size pins)
EXPECT_MP_TRAIN = {
    "full": {
        "mp-gcn-train-arxiv flat": dict(
            strategy="flat", net="derived-gpu-2x4", schedule_kind="bucketed",
            schedule_K=4, overlap=True,
            modeled_time_flat=0.00027360824533333335,
            modeled_time_schedule=0.00035481088, volume_rows=67604,
            volume_rows_padded=214696),
        "mp-gcn-train-arxiv hier": dict(
            strategy="hier", G=2, L=4, net="derived-gpu-2x4",
            schedule_kind="bucketed", schedule_K=1, overlap=True,
            modeled_time_flat=0.00027360824533333335,
            modeled_time_hier=5.7392992e-05,
            modeled_time_schedule=7.875712e-05, volume_rows=67604,
            volume_rows_padded=45904),
        "mp-gat-train-arxiv": dict(
            strategy="flat", net="derived-gpu-2x4", schedule_kind="bucketed",
            schedule_K=1, overlap=False,
            modeled_time_flat=0.00029814595200000003,
            modeled_time_schedule=0.0002203456,
            modeled_time_fused=0.00043069120000000004, volume_rows=147373,
            volume_rows_padded=156520),
    },
    "quick": {
        "mp-gcn-train-arxiv flat": dict(
            strategy="flat", net="derived-gpu-2x4", schedule_kind="bucketed",
            schedule_K=1, overlap=True,
            modeled_time_flat=9.12596728888889e-05,
            modeled_time_schedule=6.114432e-05, volume_rows=7229,
            volume_rows_padded=32144),
        "mp-gcn-train-arxiv hier": dict(
            strategy="hier", G=2, L=4, net="derived-gpu-2x4",
            schedule_kind="bucketed", schedule_K=1, overlap=True,
            modeled_time_flat=9.12596728888889e-05,
            modeled_time_hier=2.3908704e-05,
            modeled_time_schedule=2.611328e-05, volume_rows=7229,
            volume_rows_padded=4776),
        "mp-gat-train-arxiv": dict(
            strategy="flat", net="derived-gpu-2x4", schedule_kind="bucketed",
            schedule_K=1, overlap=False,
            modeled_time_flat=9.265448177777779e-05,
            modeled_time_schedule=4.164736e-05,
            modeled_time_fused=7.329472e-05, volume_rows=14440,
            volume_rows_padded=16912),
    },
}


class _Gather:
    """The fleet's host-side exchanges of phase 12: every process's copy
    of a small numpy array, and files the processes hand each other
    under the phase's directory."""

    def __init__(self, out_dir: str, me: int, n: int):
        self.dir, self.me, self.n = out_dir, me, n

    def all(self, a) -> list:
        import torch.distributed as dist

        t = torch.from_numpy(np.ascontiguousarray(a))
        parts = [torch.empty_like(t) for _ in range(self.n)]
        dist.all_gather(parts, t)
        return [p.numpy() for p in parts]

    def put(self, tag: str, **arrays) -> None:
        np.savez(os.path.join(self.dir, f"{tag}.{self.me}.npz"), **arrays)

    def get(self, tag: str, proc: int) -> dict:
        return dict(np.load(os.path.join(self.dir, f"{tag}.{proc}.npz")))


def _flat_params(params) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1).float() for p in params]
                     ).cpu().numpy()


def _fleet_step(model, loss_fn, fn, x, labels, h, params, cfg, state):
    """One fleet training step: forward, backward, the gradients summed
    over the processes (``reduce_grads``), AdamW. CUDA events around the
    three parts, host wall, and the step's gloo and staging seconds
    (each call resets the comm, so the forward's are read call by
    call)."""
    from repro_torch.optim.adamw import adamw_step

    fwd_tr = []

    def traced(*ops):
        out = fn(*ops)
        fwd_tr.append(h.comm.transport())
        return out

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    loss = loss_fn(model, x, labels, _handle_like(fn, traced))
    ev[1].record()
    loss.backward()
    ev[2].record()
    h.comm.reduce_grads(params)
    state, _ = adamw_step(cfg, params, state)
    ev[3].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    last = h.comm.transport()  # the last call's forward, every backward
    tr = {k: sum(t[k] for t in fwd_tr[:-1]) + last[k]
          for k in ("gloo_s", "stage_s", "exchanges", "staged_bytes")}
    return state, loss.detach(), {
        "fwd": ev[0].elapsed_time(ev[1]), "bwd": ev[1].elapsed_time(ev[2]),
        "upd": ev[2].elapsed_time(ev[3]), "wall": wall,
        "gloo": tr["gloo_s"] * 1e3, "stage": tr["stage_s"] * 1e3,
        "exchanges": tr["exchanges"], "staged_bytes": tr["staged_bytes"]}


def _handle_like(fn, call):
    """``call`` carrying ``fn``'s handle as the models' losses look for
    it (``DistSpmm.row_blocks`` / ``.handle``)."""
    h = fn if hasattr(fn, "row_blocks") else fn.handle
    call.handle = h
    return call


def _model_of(kind, n):
    from repro_torch.models.gnn import (
        gat_from_numpy, gat_loss, gcn_from_numpy, gcn_loss, gcn_params,
    )

    if kind == "gcn":
        weights = gcn_params(GCN_DIMS, seed=0)
        return (lambda: gcn_from_numpy(weights, n, device=MP_DEVICE),
                gcn_loss, GCN_DIMS[0], GCN_DIMS[-1])
    weights = gat_params(0)
    return (lambda: gat_from_numpy(weights, n, device=MP_DEVICE), gat_loss,
            GAT_DIMS["feat_dim"], GAT_DIMS["n_classes"])


def _axes_of(h):
    return ("x",) if h.strategy == "flat" else ("g", "l")


def mp_train_cell(args, topo, gather, what, a, kind, path, fields,
                  expect, recorded) -> dict:
    """One training cell of phase 12 on the fleet, then (process 0) the
    same plan on ``Topology.local(8)``: decisions, dB rows, the first
    step's loss and gradients, parameters equal across the processes
    after every step, the backward's rows, the op watch, per-epoch
    times. Returns this process's report."""
    from repro_torch import SpmmConfig, compile_spmm
    from repro_torch.core import make_spmm_fn
    from repro_torch.core.api import materialize_payload
    from repro_torch.distributed.topology import Topology
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    me, (lo, hi) = topo.process_index, topo.span
    epochs = MP_EPOCHS[kind]
    t0 = time.perf_counter()
    h = compile_spmm(a, topo, SpmmConfig(**fields))
    prep_s = time.perf_counter() - t0
    st = h.stats()
    got = {k: st.get(k) for k in expect if k in st}
    if got != expect:
        raise AssertionError(f"worker {me} {what}: decisions {got} != "
                             f"{expect}")
    n = a.shape[0]
    per = n // P
    rows = slice(lo * per, hi * per)
    fused = kind == "gat"
    rng = np.random.default_rng(0)
    # dB of ½‖h(operands)‖² on the fleet: this process's rows
    widths = ((GAT_DIMS["att_dim"], GAT_DIMS["att_dim"], GAT_DIMS["hidden"])
              if fused else (N_COLS,))
    ops_host = [rng.standard_normal((n, w), dtype=np.float32) for w in widths]
    xs = [topo.put_global(o).requires_grad_() for o in ops_host]
    with library_watch() as watch:
        c = h(*xs)
        watch.stage = "backward"
        c.backward(c.detach())
        torch.cuda.synchronize()
    watch.check(f"{what} dB")
    axes = _axes_of(h)
    db_rows = {ax: [h.comm.fleet_rows(ax, direction=d)
                    for d in ("fwd", "bwd")] for ax in axes}
    db_cross = [h.comm.fleet_rows(crossing=True, direction=d)
                for d in ("fwd", "bwd")]
    plan_cross = None if fused else h.plan_crossing_rows()
    if any(f != b or f == 0 for f, b in db_rows.values()) or \
            db_cross[0] != db_cross[1] or \
            (plan_cross is not None and db_cross[0] != plan_cross):
        raise AssertionError(f"{what} dB: rows (fwd, bwd) {db_rows}, "
                             f"crossing {db_cross}, plan {plan_cross}")
    gather.put(f"{path or what}-db",
               **{f"d{i}": x.grad.cpu().numpy() for i, x in enumerate(xs)})
    del c, xs

    # the first step on the fleet: counted, recorded, watched
    make_model, loss_fn, feat_dim, n_classes = _model_of(kind, n)
    feats_host = np.random.default_rng(1).standard_normal(
        (n, feat_dim), dtype=np.float32)
    labels = torch.from_numpy(np.random.default_rng(2).integers(
        0, n_classes, n)).to(topo.device)
    x = topo.put_global(feats_host)  # this process's feature rows
    fn = h if fused else make_spmm_fn(h)
    model = make_model()
    params = list(model.parameters())
    calls = GAT_DIMS["n_layers"] if fused else len(GCN_DIMS) - 1
    ops.reset_launch_counts()
    box = {}

    def first():
        box["loss"] = loss_fn(model, x, labels, fn)
        torch.cuda.synchronize()
        box["fwd"] = ops.launch_counts()
        watch.stage = "backward"
        box["loss"].backward()

    with library_watch() as watch:
        if path is not None:
            recorded[path] = (record_kernel_calls(first, host=True),
                              None)
        else:
            first()
            torch.cuda.synchronize()
    watch.check(what)
    total = ops.launch_counts()
    if path is not None:  # the step's launches, counted as recorded
        recorded[path] = (recorded[path][0], total)
    fwd = box["fwd"]
    bwd = {k: total[k] - fwd[k] for k in total}
    coo = ("gather_rows", "gather_rows_scaled", "scatter_add_rows")
    missing = [(k, d) for d, cnt in (("forward", fwd), ("backward", bwd))
               for k in coo if cnt[k] < 1]
    if missing:
        raise AssertionError(f"{what}: not launched {missing}")
    step_rows = {ax: [h.comm.fleet_rows(ax, direction=d)
                      for d in ("fwd", "bwd")] for ax in axes}
    step_cross = [h.comm.fleet_rows(crossing=True, direction=d)
                  for d in ("fwd", "bwd")]
    if any(b != calls * f or f == 0 for f, b in step_rows.values()) or \
            step_cross[1] != calls * step_cross[0] or \
            (plan_cross is not None and step_cross[0] != plan_cross):
        raise AssertionError(f"{what}: step rows (fwd, bwd) {step_rows}, "
                             f"crossing {step_cross} for {calls} calls")
    h.comm.reduce_grads(params)
    loss0 = float(h.comm.fold(box["loss"].detach()))
    gather.put(f"{what}-grads",
               **{f"g{i}": p.grad.cpu().numpy() for i, p in enumerate(params)})
    opt_cfg = AdamWConfig(total_steps=epochs, **TRAIN_OPT)
    state = adamw_init(params)
    from repro_torch.optim.adamw import adamw_step

    state, _ = adamw_step(opt_cfg, params, state)

    def same_params(step):
        mine = _flat_params(params)
        if not all(np.array_equal(mine, o) for o in gather.all(mine)):
            raise AssertionError(f"{what}: parameters differ across the "
                                 f"processes after step {step}")

    same_params(0)
    losses, times = [loss0], []
    for ep in range(1, epochs):
        state, loss, t = _fleet_step(model, loss_fn, fn, x, labels, h, params,
                                     opt_cfg, state)
        losses.append(float(h.comm.fold(loss)))
        times.append(t)
        same_params(ep)
    gather.put(f"{what}-losses", losses=np.asarray(losses))
    del model, params, state, x, box
    gc.collect()
    torch.cuda.empty_cache()
    med = {k: statistics.median(t[k] for t in times) for k in times[0]}
    out = {"decisions": {k: list(v) if isinstance(v, tuple) else v
                         for k, v in got.items()},
           "prep_s": prep_s, "rows": step_rows, "crossing": step_cross,
           "db_rows": db_rows, "db_crossing": db_cross,
           "plan_crossing": plan_cross, "losses": losses,
           "launches": {"forward": {k: fwd[k] for k in coo},
                        "backward": {k: bwd[k] for k in coo}},
           "median": med, "epochs": epochs}

    # process 0: the same plan on Topology.local(8), the same epochs
    payload = h.save_payload()
    del h, fn
    gc.collect()
    torch.cuda.empty_cache()
    import torch.distributed as dist

    dist.barrier()
    if me == 0:
        out["emulated"] = _emulated_cell(
            gather, what, path, kind, payload, ops_host, feats_host, labels,
            epochs)
    dist.barrier()
    return out


def _emulated_cell(gather, what, path, kind, payload, ops_host, feats_host,
                   labels, epochs) -> dict:
    """Process 0's half of a cell: the fleet's plan on Topology.local(8)
    on the card — dB, the first step, ``epochs`` steps — held against
    every process's saved rows, gradients and losses."""
    from repro_torch.core import make_spmm_fn
    from repro_torch.core.api import materialize_payload
    from repro_torch.distributed.topology import Topology
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_step

    emu = materialize_payload(payload, Topology.local(P, MP_DEVICE))
    n = feats_host.shape[0]
    per = n // P
    w = MP_LOCAL
    xs = [torch.from_numpy(o).to(MP_DEVICE).requires_grad_()
          for o in ops_host]
    c = emu(*xs)
    c.backward(c.detach())
    for proc in range(MP_NPROC):
        mine = gather.get(f"{path or what}-db", proc)
        rows = slice(proc * w * per, (proc + 1) * w * per)
        for i, x in enumerate(xs):
            if not np.array_equal(mine[f"d{i}"], x.grad[rows].cpu().numpy()):
                raise AssertionError(f"{what}: worker {proc}'s dB rows != "
                                     f"the emulated run's (operand {i})")
    del c, xs
    make_model, loss_fn, _, _ = _model_of(kind, n)
    fn = emu if kind == "gat" else make_spmm_fn(emu)
    feats = torch.from_numpy(feats_host).to(MP_DEVICE)
    model = make_model()
    params = list(model.parameters())
    loss = loss_fn(model, feats, labels, fn)
    loss.backward()
    worst = 0.0
    for proc in range(MP_NPROC):
        grads = gather.get(f"{what}-grads", proc)
        for i, p in enumerate(params):
            g, e = grads[f"g{i}"].astype(np.float64), _host64(p.grad)
            np.testing.assert_allclose(g, e, err_msg=f"{what} grad {i}",
                                       **GRAD_TOL)
            worst = max(worst, float((np.abs(g - e) / (
                GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(e))).max()))
    cfg = AdamWConfig(total_steps=epochs, **TRAIN_OPT)
    state = adamw_init(params)
    emu_losses, times = [loss.item()], []
    state, _ = adamw_step(cfg, params, state)
    for _ in range(1, epochs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        loss = loss_fn(model, feats, labels, fn)
        ev[1].record()
        loss.backward()
        ev[2].record()
        state, _ = adamw_step(cfg, params, state)
        ev[3].record()
        torch.cuda.synchronize()
        times.append({"fwd": ev[0].elapsed_time(ev[1]),
                      "bwd": ev[1].elapsed_time(ev[2]),
                      "upd": ev[2].elapsed_time(ev[3]),
                      "wall": (time.perf_counter() - t0) * 1e3})
        emu_losses.append(loss.item())
    for proc in range(MP_NPROC):
        np.testing.assert_allclose(
            gather.get(f"{what}-losses", proc)["losses"], emu_losses,
            err_msg=f"{what}: losses of worker {proc}", **GRAD_TOL)
    if not emu_losses[-1] < emu_losses[0]:
        raise AssertionError(f"{what}: the loss did not fall: {emu_losses}")
    del emu, model, params, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": emu_losses, "grad_err_over_tol": worst,
            "median": {k: statistics.median(t[k] for t in times)
                       for k in times[0]}}


def mp_ep_cell(args, topo, gather, recorded) -> dict:
    """The expert-parallel LM of phase 12 on a (data 1, model 8) grid over
    the fleet: OLMoE-1B-7B at its published width cut to
    ``MP_EP_LAYERS`` layers (``--quick``: olmoe-smoke) with random
    weights (seed 0), each process keeping the dense weights and its
    model ranks' experts. Returns this process's report."""
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed.context import make_context
    from repro_torch.distributed.topology import Topology
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as TM
    from repro_torch.models import transformer as TT
    from repro_torch.serving.scheduler import ContinuousBatcher, Request

    me = topo.process_index
    dev = topo.device
    cfg = get_smoke_config(LM_ARCH) if args.quick else dataclasses.replace(
        get_config(LM_ARCH), n_layers=MP_EP_LAYERS)
    ftopo = Topology.multiprocess(device=MP_DEVICE,
                                  mesh=make_mesh(*MP_EP_GRID))
    fdist = make_context(ftopo)
    edist = make_context(make_mesh(*MP_EP_GRID))
    M, dsz = fdist.model_size, fdist.batch_size_divisor
    ng, nm, _, m_lo = fdist.local_grid
    out = {"grid": dict(fdist.mesh.shape), "span": list(fdist.span),
           "model_ranks": [m_lo, m_lo + nm]}
    rng = np.random.default_rng(0)
    B, S = LM_PREFILL
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)}
    first = batch["tokens"][:, :1]
    max_len = LM_SERVE["max_len"]
    per_step = 2 * cfg.n_layers + 1

    t0 = time.perf_counter()
    full = TT.init_params(cfg, torch.Generator(dev).manual_seed(0),
                          device=dev)
    torch.cuda.synchronize()
    if me == 0:  # the emulated grid's bf16 tokens, on all the experts
        cache = TT.init_decode_cache(cfg, B, max_len, device=dev)
        emu_pre = TT.forward(full, cfg, edist, batch)
        emu_dec, _ = TT.decode_step(full, cfg, edist, first, cache)
        out["emulated_tokens"] = [emu_pre[:, -1].argmax(-1).tolist(),
                                  emu_dec[:, -1].argmax(-1).tolist()]
        del emu_pre, emu_dec
        del cache
    params = TT.shard_experts(full, cfg, fdist)
    moe = params["layers"]["moe"]
    for k in ("w1", "w3", "w2"):
        moe[k] = moe[k].clone()  # the experts alone, not views of them all
    del full
    gc.collect()
    torch.cuda.empty_cache()
    held = sum(t.numel() * t.element_size() for t in _leaves(params))
    out["weights_gb"] = held / 1e9
    log(f"[worker {me}] EP: {cfg.name} on {dict(fdist.mesh.shape)} ranks "
        f"{fdist.span}, model ranks {m_lo}..{m_lo + nm - 1}: "
        f"{held / 1e9:.2f} GB of weights on the card, init "
        f"{time.perf_counter() - t0:.1f} s")

    # the kernel calls of one prefill and one decode step, outside the
    # counted runs, to the host
    pre_calls = record_kernel_calls(
        lambda: TT.forward(params, cfg, fdist, batch), host=True)
    cache = TT.init_decode_cache(cfg, B, max_len, device=dev)
    dec_calls = record_kernel_calls(
        lambda: TT.decode_step(params, cfg, fdist, first, cache), host=True)

    # the main path, counted: one prefill, one decode step
    want_launch = {"gather_rows": 2 * cfg.n_layers,
                   "scatter_add_rows": 2 * cfg.n_layers, "rmsnorm": per_step}
    fdist.comm.reset()
    ops.reset_launch_counts()
    with TM.record_dispatch() as rec:
        logits = TT.forward(params, cfg, fdist, batch)
    torch.cuda.synchronize()
    pre_launches = ops.launch_counts()
    check_finite(logits, (B, S, cfg.vocab_size), "fleet EP prefill logits")
    (cap, cap_e), = {(r["cap"], r["cap_e"]) for r in rec}
    acts = fdist.comm.fleet_rows("model")
    if acts != 2 * cfg.n_layers * dsz * M * M * cap:
        raise AssertionError(f"fleet EP prefill: activation rows {acts}, want"
                             f" {2 * cfg.n_layers} x Dsz·M·M·cap")
    cross = fdist.comm.fleet_rows("model", crossing=True)
    transport = fdist.comm.transport()
    tokens = logits[:, -1].argmax(-1)
    cache = TT.init_decode_cache(cfg, B, max_len, device=dev)
    ops.reset_launch_counts()
    step_logits, _ = TT.decode_step(params, cfg, fdist, first, cache)
    torch.cuda.synchronize()
    dec_launches = ops.launch_counts()
    check_finite(step_logits, (B, 1, cfg.vocab_size), "fleet EP decode")
    recorded["mp_ep_prefill"] = (pre_calls, pre_launches)
    recorded["mp_ep_decode"] = (dec_calls, dec_launches)
    for name, cnt in (("prefill", pre_launches), ("decode", dec_launches)):
        if {k: cnt[k] for k in want_launch} != want_launch or \
                sum(cnt.values()) != sum(want_launch.values()):
            raise AssertionError(f"fleet EP {name}: launches {cnt}, want "
                                 f"{want_launch}")
    mine = np.concatenate([logits[:, -1].float().cpu().numpy().ravel(),
                           step_logits.float().cpu().numpy().ravel()])
    if not all(np.array_equal(mine, o) for o in gather.all(mine)):
        raise AssertionError("fleet EP: the processes' logits differ")
    out.update(cap=cap, cap_e=cap_e, activation_rows=acts,
               crossing_rows=cross,
               crossing_bytes=cross * cfg.d_model * 2,
               transport=transport, prefill_launches=pre_launches,
               decode_launches=dec_launches,
               dropped=[int(r["dropped"]) for r in rec],
               tokens=[tokens.tolist(),
                       step_logits[:, -1].argmax(-1).tolist()])
    del logits, step_logits

    # the batcher: phase 7's 12 requests
    reqs = lm_requests(Request, cfg.vocab_size)
    batcher = ContinuousBatcher(cfg, params, LM_SERVE["max_batch"], max_len,
                                dist=fdist)
    for r in reqs:
        batcher.submit(r)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stats = batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    want_tokens = LM_SERVE["requests"] * LM_SERVE["new_tokens"]
    if stats.served != LM_SERVE["requests"] or \
            stats.generated_tokens != want_tokens:
        raise AssertionError(f"fleet EP batcher: served {stats.served}, "
                             f"{stats.generated_tokens} tokens")
    outs = np.asarray([t for r in reqs for t in r.output], np.int64)
    if not all(np.array_equal(outs, o) for o in gather.all(outs)):
        raise AssertionError("fleet EP batcher: the processes' tokens differ")
    out["batcher"] = {"served": stats.served, "tokens": want_tokens,
                      "steps": stats.decode_steps, "wall_s": wall,
                      "tokens_per_s": want_tokens / wall,
                      "outputs_digest": int(outs.sum())}

    # medians of 3 (a fleet prefill moves GBs through the host)
    for fn, key in ((lambda: TT.forward(params, cfg, fdist, batch),
                     "prefill"),
                    (lambda: TT.decode_step(params, cfg, fdist, first, cache),
                     "decode")):
        fdist.comm.reset()
        out[f"{key}_ms"] = median_ms(fn, reps=3)
        tr = fdist.comm.transport()
        out[f"{key}_gloo_ms"] = tr["gloo_s"] * 1e3 / 3
        out[f"{key}_stage_ms"] = tr["stage_s"] * 1e3 / 3
    del cache, batcher, params
    gc.collect()
    torch.cuda.empty_cache()
    out["f32"] = mp_ep_f32(args, cfg, fdist, edist, me, gather, dev)
    return out


def mp_ep_f32(args, cfg, fdist, edist, me, gather, dev) -> dict:
    """A float32 copy of the first 2 layers (all experts drawn, each
    process keeping its own): the fleet against the emulated grid and
    ``_moe_dense`` at capacity 8.0, the sequence-sharded decode against
    the unsharded one, every model rank's output equal, the drops at the
    published capacity equal the emulated run's."""
    from repro_torch.models import moe as TM
    from repro_torch.models import transformer as TT

    n_l = min(LM_F32["n_layers"], cfg.n_layers)
    c2 = dataclasses.replace(cfg, n_layers=n_l)
    full = TT.init_params(c2, torch.Generator(dev).manual_seed(0),
                          device=dev)  # the first layers of phase 7's draw
    full = TT._tree_map(lambda t: t.float(), full)
    mine = TT.shard_experts(full, cfg, fdist)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        LM_F32["batch"], LM_F32["tokens"])).astype(np.int32)).to(dev)
    f32 = {"tokens": toks}

    def copy(**kw):
        return dataclasses.replace(c2, dtype="float32", **kw)

    wide = copy(capacity_factor=8.0)
    fleet = TT.forward(mine, wide, fdist, f32)
    emu = TT.forward(full, wide, edist, f32)
    dense = TT.forward(full, wide, None, f32)
    res = {"vs_emulated": check_close(fleet, _host64(emu),
                                      "fleet EP vs emulated"),
           "vs_dense": check_close(fleet, _host64(dense),
                                   "fleet EP vs _moe_dense")}
    steps = {}
    for shard_kv in (False, True):
        c32 = dataclasses.replace(wide, kv_seq_shard=shard_kv)
        cache = TT.init_decode_cache(c32, toks.shape[0], toks.shape[1],
                                     device=dev)
        outs = []
        for j in range(toks.shape[1]):
            o, cache = TT.decode_step(mine, c32, fdist, toks[:, j:j + 1],
                                      cache)
            outs.append(o)
        steps[shard_kv] = torch.cat(outs, dim=1)
    res["seq_shard"] = check_close(steps[True], _host64(steps[False]),
                                   "fleet seq-shard decode")
    res["decode_vs_forward"] = check_close(steps[False], _host64(fleet),
                                           "fleet decode vs forward")
    lp = TT._layer(mine["layers"], 0)["moe"]
    x = torch.randn((LM_F32["batch"], LM_F32["tokens"], cfg.d_model),
                    generator=torch.Generator(dev).manual_seed(1),
                    device=dev)
    ranks = TM._moe_ep(lp, x, wide, fdist, True, all_ranks=True)
    first = ranks[0].cpu().numpy()
    if not all(torch.equal(r, ranks[0]) for r in ranks) or \
            not all(np.array_equal(first, o) for o in gather.all(first)):
        raise AssertionError("fleet EP: the model ranks' outputs differ")
    pub = copy()
    with TM.record_dispatch() as rf:
        TT.forward(mine, pub, fdist, f32)
    with TM.record_dispatch() as re_:
        TT.forward(full, pub, edist, f32)
    drops = [int(sum(x)) for x in zip(*gather.all(np.asarray(
        [int(r["dropped"]) for r in rf], np.int64)))]
    if drops != [int(r["dropped"]) for r in re_]:
        raise AssertionError(f"fleet drops {drops} != emulated "
                             f"{[int(r['dropped']) for r in re_]}")
    res["dropped"] = drops
    del full, mine, fleet, emu, dense, steps, ranks
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _f32_vs_emulated(cfg, full, mine, fdist, edist, batch, what, dev):
    """A float32 copy's forward and its teacher-forced decode steps on the
    fleet against the emulated grid's rows, within 2e-4 (and whether
    ``torch.equal``)."""
    from repro_torch.models import transformer as TT

    c32 = dataclasses.replace(cfg, dtype="float32")
    f32 = lambda t: TT._tree_map(lambda x: x.float(), t)  # noqa: E731
    full, mine = f32(full), f32(mine)
    B = batch["tokens"].shape[0]
    lo, hi = fdist.local_rows(B)
    toks = batch["tokens"][:, :LM_F32["tokens"]]
    res = {}
    got = TT.forward(mine, c32, fdist, {"tokens": toks})
    want = TT.forward(full, c32, edist, {"tokens": toks})[lo:hi]
    res["forward"] = check_close(got, _host64(want), f"{what} forward")
    res["forward_equal"] = bool(torch.equal(got, want))
    caches = [TT.init_decode_cache(c32, B, toks.shape[1], device=dev)
              for _ in range(2)]
    equal, outs = True, []
    for j in range(toks.shape[1]):
        t = toks[:, j:j + 1]
        lf, caches[0] = TT.decode_step(mine, c32, fdist, t, caches[0])
        le, caches[1] = TT.decode_step(full, c32, edist, t, caches[1])
        equal &= bool(torch.equal(lf, le[lo:hi]))
        outs.append((lf, le[lo:hi]))
    res["decode"] = check_close(torch.cat([o[0] for o in outs], 1),
                                _host64(torch.cat([o[1] for o in outs], 1)),
                                f"{what} decode")
    res["decode_equal"] = equal
    del full, mine, caches, outs
    return res


def mp_pod_cell(args, topo, gather, recorded) -> dict:
    """The EP LM on a (pod 2, data 2, model 2) grid over the fleet (one
    pod a worker): ``MP_POD``'s prefill and one decode step, counted, the
    logits against the emulated grid's (bf16: ``torch.equal`` reported,
    held to ``MP_FAMILY_ROWS_TOL`` of their largest magnitude), and a
    float32 copy's forward and decode within 2e-4. Path ``mp_pod``: both
    calls' kernels."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed.context import make_context
    from repro_torch.distributed.topology import Topology
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as TT

    me, dev = topo.process_index, topo.device
    cfg = get_smoke_config(LM_ARCH) if args.quick else dataclasses.replace(
        get_config(LM_ARCH), n_layers=MP_POD["layers"])
    fdist = make_context(Topology.multiprocess(
        device=MP_DEVICE, mesh=make_mesh(*MP_POD_GRID)))
    edist = make_context(make_mesh(*MP_POD_GRID))
    B, S = MP_POD["batch"], MP_POD["seq"]
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)}
    first = batch["tokens"][:, :1]
    lo, hi = fdist.local_rows(B)
    full = TT.init_params(cfg, torch.Generator(dev).manual_seed(0),
                          device=dev)
    emu_pre = TT.forward(full, cfg, edist, batch)[lo:hi]
    cache = TT.init_decode_cache(cfg, B, S, device=dev)
    emu_dec = TT.decode_step(full, cfg, edist, first, cache)[0][lo:hi]
    params = TT.shard_experts(full, cfg, fdist)
    calls = record_kernel_calls(
        lambda: TT.forward(params, cfg, fdist, batch), host=True)
    cache = TT.init_decode_cache(cfg, B, S, device=dev)
    for k, got in record_kernel_calls(
            lambda: TT.decode_step(params, cfg, fdist, first, cache),
            host=True).items():
        calls[k].extend(got)
    fdist.comm.reset()
    ops.reset_launch_counts()
    pre, pre_ms, pre_host = _timed(lambda: TT.forward(params, cfg, fdist,
                                                      batch))
    cache = TT.init_decode_cache(cfg, B, S, device=dev)
    (dec, _), dec_ms, dec_host = _timed(
        lambda: TT.decode_step(params, cfg, fdist, first, cache))
    launches = ops.launch_counts()
    tr = fdist.comm.transport()
    per_call = {"gather_rows": 2 * cfg.n_layers,
                "scatter_add_rows": 2 * cfg.n_layers,
                "rmsnorm": 2 * cfg.n_layers + 1}
    if {k: launches[k] for k in per_call} != \
            {k: 2 * n for k, n in per_call.items()}:
        raise AssertionError(f"mp_pod: launches {launches}, want twice "
                             f"{per_call}")
    check_finite(pre, (hi - lo, S, cfg.vocab_size), "mp_pod prefill")
    check_finite(dec, (hi - lo, 1, cfg.vocab_size), "mp_pod decode")
    res = {"span": list(fdist.span), "rows": [lo, hi],
           "groups": list(fdist.local_span.groups),
           "launches": launches, "transport": tr,
           "prefill_ms": [pre_ms, pre_host], "decode_ms": [dec_ms, dec_host]}
    for key, got, want in (("prefill", pre, emu_pre),
                           ("decode", dec, emu_dec)):
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        if not err <= MP_FAMILY_ROWS_TOL * scale:
            raise AssertionError(f"mp_pod {key}: logits {err} from the "
                                 f"emulated grid's (largest {scale})")
        res[key] = {"equal": bool(torch.equal(got, want)), "max_err": err,
                    "scale": scale}
    del pre, dec, emu_pre, emu_dec, cache
    res["f32"] = _f32_vs_emulated(cfg, full, params, fdist, edist, batch,
                                  "mp_pod float32", dev)
    recorded["mp_pod"] = (calls, launches)
    del full, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def mp_ragged_worker(args) -> None:
    """One process of phase 12's ragged launch (``MP_RAGGED``): the LM
    train step on (data 3, model 2) over 2 processes x 3 ranks — one
    kernel-recorded step (worker 0 keeps it), ``MP_RAGGED["steps"]``
    counted ``make_train_step`` steps with each parameter's bit digest,
    the last parameters saved for the twin, one step split by CUDA events,
    a float32 copy's forward and decode against the emulated grid, then
    worker 0 replays its calls against the plain versions. Writes
    ``<dir>/ragged<i>.json``."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.context import make_context
    from repro_torch.distributed.topology import Topology
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.multiprocess import initialize, shutdown
    from repro_torch.models import transformer as TT
    from repro_torch.optim.adamw import AdamWConfig, _leaves, adamw_init
    from repro_torch.train.steps import loss_and_grads, make_train_step

    t_start = time.perf_counter()
    out_dir = args.mp_ragged_worker
    topo = initialize(timeout=MP_TIMEOUT)
    me, dev = topo.process_index, topo.device
    torch.backends.cuda.matmul.allow_tf32 = False
    path = "mp_ragged_train"
    cfg = mp_lm_config(args, True)
    grid = (MP_RAGGED["grid"], ("data", "model"))
    fdist = make_context(Topology.multiprocess(device=MP_DEVICE,
                                               mesh=make_mesh(*grid)))
    edist = make_context(make_mesh(*grid))
    batch = {"tokens": torch.from_numpy(SyntheticLM(
        cfg.vocab_size, MP_RAGGED["seq"], MP_RAGGED["batch"],
        seed=0).batch(0)["tokens"]).to(dev)}
    opt = AdamWConfig(**MP_LM_OPT)
    reset_peak()
    full = TT.init_params(cfg, torch.Generator(dev).manual_seed(0),
                          device=dev)
    params = TT.shard_experts(full, cfg, fdist)
    n_params = sum(t.numel() for t in _leaves(params))
    span = fdist.local_span
    calls = record_kernel_calls(
        lambda: loss_and_grads(params, cfg, fdist, batch), host=True)
    if me != 0:
        del calls
    sources = fdist.grad_sources(params, cfg)
    fdist.comm.reset()
    ops.reset_launch_counts()
    step = make_train_step(cfg, fdist, opt)
    p, state, steps = params, adamw_init(params), []
    for _ in range(MP_RAGGED["steps"]):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        p, state, met = step(p, state, batch)
        torch.cuda.synchronize()
        steps.append({"wall_ms": (time.perf_counter() - t1) * 1e3,
                      "loss": float(met["loss"]),
                      "grad_norm": float(met["grad_norm"]),
                      "digests": [bits_digest(t) for t in _leaves(p)]})
    launches = ops.launch_counts()
    tr = fdist.comm.transport()
    want = ("gather_rows", "scatter_add_rows", "rmsnorm", "rmsnorm_bwd")
    if min(launches[k] for k in want) < 1:
        raise AssertionError(f"{path}: a kernel of the path was not "
                             f"launched: {launches}")
    torch.save([t.cpu() for t in _leaves(p)],
               os.path.join(out_dir, f"{path}.{me}.pt"))
    *_, ms = split_train_step(cfg, fdist, opt, p, state, batch, sources)
    del p, state
    gc.collect()
    torch.cuda.empty_cache()
    f32 = _f32_vs_emulated(cfg, full, params, fdist, edist, batch,
                           f"{path} float32", dev)
    del full, params
    gc.collect()
    torch.cuda.empty_cache()
    out = {"process": me, "span": list(fdist.span),
           "ranks": [list(r) for r in span.ranks],
           "models": list(span.models), "counted": list(fdist.counted_groups),
           "steps": steps, "launches": launches, "split_ms": ms,
           "transport": tr, "f32": f32, "peak_gb": peak_allocated() / 1e9,
           "params": n_params}
    rows = {}
    if me == 0:
        t0 = time.perf_counter()
        for k in want:
            rows.setdefault(k, {})[path] = kernel_row(k, calls[k],
                                                      launches[k], busy=False)
        del calls
        log(f"[ragged worker 0] {path} calls replayed in "
            f"{time.perf_counter() - t0:.1f} s")
    out["kernels"] = rows
    out["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"ragged{me}.json"), "w") as f:
        json.dump(out, f)
    shutdown()


def mp_ragged_twin(args, res, out_dir, card: str, dev: str = "cuda") -> None:
    """``mp_ragged_train``'s emulated twin in the phase's process: the same
    weights, batch and steps on ``make_mesh((3, 2))``; each step's loss
    and grad norm and every parameter each worker holds (digests each
    step, the saved values after the last) within ``MP_LM_TWIN_TOL``."""
    from repro_torch.distributed.context import make_context
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as TT
    from repro_torch.optim.adamw import AdamWConfig, _leaves, adamw_init
    from repro_torch.train.steps import make_train_step

    from repro_torch.data.pipeline import SyntheticLM

    path = "mp_ragged_train"
    cfg = mp_lm_config(args, True)
    edist = make_context(make_mesh(MP_RAGGED["grid"], ("data", "model")))
    batch = {"tokens": torch.from_numpy(SyntheticLM(
        cfg.vocab_size, MP_RAGGED["seq"], MP_RAGGED["batch"],
        seed=0).batch(0)["tokens"]).to(dev)}
    p = TT.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    step = make_train_step(cfg, edist, AdamWConfig(**MP_LM_OPT))
    state = adamw_init(p)
    worst = dict(loss=0.0, grad_norm=0.0, param=0.0)
    equal = []
    for i in range(MP_RAGGED["steps"]):
        p, state, met = step(p, state, batch)
        loss, norm = float(met["loss"]), float(met["grad_norm"])
        digests = [bits_digest(t) for t in _leaves(p)]
        for r in res:
            st = r["steps"][i]
            dl = abs(st["loss"] - loss) / abs(loss)
            dn = abs(st["grad_norm"] - norm) / norm
            worst["loss"] = max(worst["loss"], dl)
            worst["grad_norm"] = max(worst["grad_norm"], dn)
            equal.append(dl == 0 and dn == 0 and digests == st["digests"])
    for r in res:  # both workers hold every expert on (data 3, model 2)
        saved = torch.load(os.path.join(out_dir, f"{path}.{r['process']}.pt"))
        for t, s_ in zip(_leaves(p), saved):
            worst["param"] = max(worst["param"], float(
                (t.float() - s_.to(dev).float()).abs().max()))
    if not all(worst[k] <= MP_LM_TWIN_TOL[k] for k in worst):
        raise AssertionError(f"{path}: fleet vs emulated twin {worst} past "
                             f"{MP_LM_TWIN_TOL}")
    r0 = res[0]
    log(f"{path}: {cfg.name} ({r0['params']:,} parameters a worker) on "
        f"{dict(edist.mesh.shape)} over {MP_RAGGED['nproc']} x "
        f"{MP_RAGGED['local']} ranks; spans {[r['ranks'] for r in res]}, "
        f"experts of model ranks {[r['models'] for r in res]}, counted "
        f"groups {[r['counted'] for r in res]}; losses "
        f"{[x['loss'] for x in r0['steps']]}, grad norms "
        f"{[x['grad_norm'] for x in r0['steps']]}; vs the emulated twin: "
        f"torch.equal at {sum(equal)} of {len(equal)} (step, worker) pairs; "
        f"worst relative loss {worst['loss']:.3g}, grad norm "
        f"{worst['grad_norm']:.3g}, parameter abs {worst['param']:.3g} "
        f"(limits {MP_LM_TWIN_TOL})")
    for r in res:
        ms, tr = r["split_ms"], r["transport"]
        log(f"  {path} worker {r['process']} [{card}]: steps' host wall "
            f"{[round(x['wall_ms'], 3) for x in r['steps']]} ms; a step by "
            f"CUDA events: forward {ms['fwd']:.3f}, backward {ms['bwd']:.3f},"
            f" fold {ms['fold']:.3f}, update {ms['upd']:.3f} ms, host wall "
            f"{ms['wall']:.3f} ms; 3 steps' gloo {tr['gloo_s']:.3f} s, "
            f"staging {tr['stage_s']:.3f} s, fold {tr['fold_bytes']} B sent,"
            f" exchanges {tr['exchanges']} ({tr['bwd_exchanges']} backward);"
            f" launches {json.dumps(r['launches'])}; peak "
            f"{r['peak_gb']:.2f} GB; float32 copy: forward "
            f"{r['f32']['forward']} (torch.equal {r['f32']['forward_equal']})"
            f", decode {r['f32']['decode']} (torch.equal "
            f"{r['f32']['decode_equal']}); worker {r['seconds']:.1f} s")
    del p, state, step
    gc.collect()
    torch.cuda.empty_cache()


def mp_lm_config(args, moe: bool):
    """Phase 12's LM train config: OLMoE-1B-7B (``--quick``: its smoke
    config) cut to ``MP_LM_TRAIN["layers"]``; ``moe`` False gives the
    dense family at the same widths (a SwiGLU MLP of d_ff)."""
    from repro_torch.configs import get_config, get_smoke_config

    base = get_smoke_config(LM_ARCH) if args.quick else get_config(LM_ARCH)
    cfg = dataclasses.replace(base, n_layers=MP_LM_TRAIN["layers"])
    return cfg if moe else dataclasses.replace(cfg, family="dense")


def mp_lm_batch(cfg, dev):
    from repro_torch.data.pipeline import SyntheticLM

    toks = SyntheticLM(cfg.vocab_size, MP_LM_TRAIN["seq"],
                       MP_LM_TRAIN["batch"], seed=0).batch(0)["tokens"]
    return {"tokens": torch.from_numpy(toks).to(dev)}


def bits_digest(t: torch.Tensor) -> int:
    """A position-weighted sum of ``t``'s bit patterns: equal tensors give
    equal digests (any change of a bit or a position almost surely
    changes it)."""
    v = t.detach().reshape(-1)
    v = v.view({2: torch.int16, 4: torch.int32}[v.element_size()])
    total = 0
    for lo in range(0, v.numel(), 1 << 25):
        part = v[lo:lo + (1 << 25)].to(torch.int64)
        w = torch.arange(lo, lo + part.numel(), device=v.device) % 65521 + 1
        total += int((part * w).sum())
    return total


class _Repeat:
    """A data source (``batch(step)``) whose every step is one batch."""

    def __init__(self, batch):
        self.b = batch

    def batch(self, step, shard=0, n_shards=1):
        return self.b


def mp_lm_fit(cfg, fdist, opt, params, batch, ckpt_dir):
    """``MP_LM_TRAINER``'s counted run: ``Trainer.fit`` on the fleet for
    ``MP_LM_TRAIN["steps"]`` steps of the repeated batch, a checkpoint
    every ``MP_LM_CKPT_EVERY`` (worker 0 writes), each step timed and
    every parameter's bit digest kept. Returns (params, opt state, the
    steps, the trainer's checkpoint timings)."""
    from repro_torch.optim.adamw import _leaves as leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig

    steps = []
    tr = Trainer(cfg, opt, TrainerConfig(
        total_steps=MP_LM_TRAIN["steps"], ckpt_every=MP_LM_CKPT_EVERY,
        ckpt_dir=ckpt_dir, log_every=1,
        straggler_warmup=MP_LM_TRAIN["steps"]), fdist)
    inner = tr.step_fn

    def step(p, state, b):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        p, state, met = inner(p, state, b)
        torch.cuda.synchronize()
        steps.append({"wall_ms": (time.perf_counter() - t1) * 1e3,
                      "loss": float(met["loss"]),
                      "grad_norm": float(met["grad_norm"]),
                      "digests": [bits_digest(t) for t in leaves(p)]})
        return p, state, met

    tr.step_fn = step
    out = tr.fit(params, _Repeat(batch), resume=False)
    if out["params"] is not params or out["last_step"] != len(steps):
        raise AssertionError(f"{MP_LM_TRAINER}: fit returned another tree "
                             f"or stopped at {out['last_step']}")
    return out["params"], out["opt_state"], steps, tr.ckpt.timings


def mp_lm_resume(cfg, fdist, opt, p, batch, ckpt_dir, want) -> tuple:
    """Worker 0 deletes the last checkpoint; a second ``Trainer.fit``
    resumes into ``p`` from the one before and must end on ``want`` (the
    uninterrupted run's parameters, on the host), ``torch.equal``.
    Returns (params, opt state, the report)."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.optim.adamw import _leaves as leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig

    last = MP_LM_TRAIN["steps"]
    if fdist.comm.proc == 0:
        shutil.rmtree(CheckpointManager(ckpt_dir)._step_dir(last))
    fdist.comm.barrier()
    t0 = time.perf_counter()
    tr = Trainer(cfg, opt, TrainerConfig(
        total_steps=last, ckpt_every=MP_LM_CKPT_EVERY, ckpt_dir=ckpt_dir,
        log_every=1, straggler_warmup=last), fdist)
    out = tr.fit(p, _Repeat(batch), resume=True)
    seconds = time.perf_counter() - t0
    first = out["history"][0]["step"]
    equal = all(torch.equal(a.cpu(), b) for a, b in
                zip(leaves(out["params"]), want))
    if first != (last - 1) // MP_LM_CKPT_EVERY * MP_LM_CKPT_EVERY \
            or not equal:
        raise AssertionError(f"{MP_LM_TRAINER}: the run resumed at step "
                             f"{first} ended equal to the uninterrupted "
                             f"run: {equal}")
    return out["params"], out["opt_state"], {
        "first_step": first, "equal": equal, "seconds": seconds,
        "timings": tr.ckpt.timings,
        "all_steps": tr.ckpt.all_steps() if tr.ckpt.lead else None}


def _ckpt_brief(ckpt) -> str:
    """The checkpoints' host seconds, one (op, step, s) each."""
    if ckpt is None:
        return ""
    ops_ = [(t["op"], t["step"], round(t["seconds"], 1))
            for t in ckpt["saves"] + ckpt["timings"]]
    return (f"; checkpoints (op, step, s) {ops_}, resumed fit "
            f"{ckpt['seconds']:.1f} s")


def mp_lm_train_cell(args, topo, recorded, out_dir) -> dict:
    """Phase 12's LM train step on the fleet, each of ``MP_LM_CASES``:
    random weights (``torch.Generator`` seed 0 on the card; this process
    keeps its model ranks' experts), one kernel-recorded step (worker 0
    keeps the calls), ``MP_LM_TRAIN["steps"]`` counted
    ``make_train_step`` steps (``MP_LM_TRAINER``: ``Trainer.fit`` with
    its checkpoints, ``mp_lm_fit``) with every parameter's bit digest
    after each, the last step's parameters saved for the emulated twin,
    (``MP_LM_TRAINER``: the resumed run, ``mp_lm_resume``), then one more
    step split by CUDA events. Returns this process's report."""
    from repro_torch.distributed.context import make_context
    from repro_torch.distributed.topology import Topology
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as TT
    from repro_torch.optim.adamw import AdamWConfig, _leaves, adamw_init
    from repro_torch.train.steps import loss_and_grads, make_train_step

    me, dev = topo.process_index, topo.device
    opt = AdamWConfig(**MP_LM_OPT)
    out = {}
    for path, grid, moe in MP_LM_CASES:
        t0 = time.perf_counter()
        cfg = mp_lm_config(args, moe)
        fdist = make_context(Topology.multiprocess(
            device=MP_DEVICE, mesh=make_mesh(grid, ("data", "model"))))
        batch = mp_lm_batch(cfg, dev)
        gc.collect()
        torch.cuda.empty_cache()
        reset_peak()
        full = TT.init_params(cfg, torch.Generator(dev).manual_seed(0),
                              device=dev)
        params = TT.shard_experts(full, cfg, fdist)
        if moe:
            m = params["layers"]["moe"]
            for k in ("w1", "w3", "w2"):
                m[k] = m[k].clone()  # the experts alone, not views of all
        del full
        gc.collect()
        torch.cuda.empty_cache()
        _, nm, _, m_lo = fdist.local_grid
        e_loc = cfg.n_experts // fdist.model_size if moe else 0
        # one step's kernel calls, outside the counted runs (every process
        # runs it: its exchanges are collective; worker 0 keeps them)
        calls = record_kernel_calls(
            lambda: loss_and_grads(params, cfg, fdist, batch), host=True)
        if me != 0:
            del calls
        sources = fdist.grad_sources(params, cfg)
        fdist.comm.reset()
        ops.reset_launch_counts()
        ckpt_dir = os.path.join(out_dir, "lm_ckpt")
        if path == MP_LM_TRAINER:
            p, state, steps, saves = mp_lm_fit(cfg, fdist, opt, params,
                                               batch, ckpt_dir)
        else:
            step = make_train_step(cfg, fdist, opt)
            p, state, steps = params, adamw_init(params), []
            for _ in range(MP_LM_TRAIN["steps"]):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                p, state, met = step(p, state, batch)
                torch.cuda.synchronize()
                steps.append({"wall_ms": (time.perf_counter() - t1) * 1e3,
                              "loss": float(met["loss"]),
                              "grad_norm": float(met["grad_norm"]),
                              "digests": [bits_digest(t)
                                          for t in _leaves(p)]})
        launches = ops.launch_counts()
        tr = fdist.comm.transport()
        cross = {d: fdist.comm.fleet_rows(None, crossing=True, direction=d)
                 for d in ("fwd", "bwd")}
        want = ("gather_rows", "scatter_add_rows", "rmsnorm", "rmsnorm_bwd")
        if min(launches[k] for k in want) < 1:
            raise AssertionError(f"{path}: a kernel of the path was not "
                                 f"launched: {launches}")
        for st in steps:
            if not math.isfinite(st["loss"]) or not st["grad_norm"] > 0:
                raise AssertionError(f"{path}: step {st}")
        # for the twin, outside every timed step, on disk before the next
        # case starts (its dirty pages would stall that case's host)
        host = [t.cpu() for t in _leaves(p)]
        with open(os.path.join(out_dir, f"{path}.{me}.pt"), "wb") as f:
            torch.save(host, f)
            f.flush()
            os.fsync(f.fileno())
        ckpt = None
        if path == MP_LM_TRAINER:
            del state
            p, state, ckpt = mp_lm_resume(cfg, fdist, opt, p, batch,
                                          ckpt_dir, host)
            ckpt["saves"] = saves
        del host
        # the donating step, timed: it consumes p and state
        *_, ms = split_train_step(cfg, fdist, opt, p, state, batch,
                                  sources)
        if me == 0:
            recorded[path] = (calls, launches)
        out[path] = {
            "grid": list(grid), "span": list(fdist.span),
            "counts_rows": fdist.counts_rows,
            "experts": [m_lo * e_loc, (m_lo + nm) * e_loc] if moe else None,
            "params": sum(t.numel() for t in _leaves(params)),
            "steps": steps, "launches": launches, "split_ms": ms,
            "transport": tr, "crossing_rows": cross,
            "crossing_bytes": (cross["fwd"] + cross["bwd"]) * cfg.d_model
            * torch.tensor([], dtype=getattr(torch, cfg.dtype)).element_size(),
            "ckpt": ckpt, "rss_gb": host_rss_gb(),
            "peak_gb": peak_allocated() / 1e9,
            "seconds": time.perf_counter() - t0}
        log(f"[worker {me}] {path}: {out[path]['seconds']:.1f} s, peak "
            f"{out[path]['peak_gb']:.2f} GB{_ckpt_brief(ckpt)}")
        del p, state, params
        release_host_memory()
    return out


def mp_lm_twin(args, res, out_dir, card: str, dev: str = "cuda") -> None:
    """The emulated twin of phase 12's LM train step, in the phase's own
    process after the workers exit: the same weights, batch and steps on
    ``make_mesh`` of each case's grid. Every step's loss and grad norm and
    every parameter each worker holds (bit digests after every step, the
    saved parameters after the last) are held within ``MP_LM_TWIN_TOL``
    and reported ``torch.equal`` or not (the CPU tests hold one data group
    over the fleet equal); the dense case's first loss within 5e-3 of the
    unsharded port's (the reference's ``tests/test_system.py`` bound; the
    EP cases drop tokens at the published capacity, so theirs is logged)."""
    from repro_torch.distributed.context import make_context
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as TT
    from repro_torch.optim.adamw import AdamWConfig, _leaves, adamw_init
    from repro_torch.train.steps import loss_and_grads, make_train_step

    opt = AdamWConfig(**MP_LM_OPT)

    def held(leaf, name, rng):
        if rng is None or "moe/w" not in name:
            return leaf
        return leaf[:, rng[0]:rng[1]]

    for path, grid, moe in MP_LM_CASES:
        t0 = time.perf_counter()
        cfg = mp_lm_config(args, moe)
        edist = make_context(make_mesh(grid, ("data", "model")))
        batch = mp_lm_batch(cfg, dev)
        params = TT.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                device=dev)
        unsharded = float(loss_and_grads(params, cfg, None, batch)[0])
        names = list(_leaf_names(params))
        step = make_train_step(cfg, edist, opt)
        p, state = params, adamw_init(params)
        cases = [r["lm_train"][path] for r in res]
        worst = dict(loss=0.0, grad_norm=0.0, param=0.0)
        equal = []  # (step, worker): loss, norm and every parameter
        firsts = []  # (step, worker): loss equal, norm equal, params equal
        at_ckpt = None
        for i in range(MP_LM_TRAIN["steps"]):
            if i == MP_LM_CKPT_EVERY and path == MP_LM_TRAINER:
                at_ckpt = (p, state)  # the twin at the checkpoint's step
            p, state, met = step(p, state, batch)
            loss, norm = float(met["loss"]), float(met["grad_norm"])
            for q, c in enumerate(cases):
                st = c["steps"][i]
                dl = abs(st["loss"] - loss) / abs(loss)
                dn = abs(st["grad_norm"] - norm) / norm
                worst["loss"] = max(worst["loss"], dl)
                worst["grad_norm"] = max(worst["grad_norm"], dn)
                digests = [bits_digest(held(t, n, c["experts"]))
                           for t, n in zip(_leaves(p), names)]
                equal.append(dl == 0 and dn == 0
                             and digests == st["digests"])
                firsts.append((i + 1, q, dl == 0, dn == 0,
                               digests == st["digests"]))
        for q, c in enumerate(cases):
            saved = torch.load(os.path.join(out_dir, f"{path}.{q}.pt"))
            for t, n, s_ in zip(_leaves(p), names, saved):
                want, got = held(t, n, c["experts"]), s_.to(dev)
                worst["param"] = max(worst["param"], float(
                    (want.float() - got.float()).abs().max()))
                equal[-len(cases) + q] &= bool(torch.equal(want, got))
        if not all(worst[k] <= MP_LM_TWIN_TOL[k] for k in worst):
            raise AssertionError(f"{path}: fleet vs emulated twin {worst} "
                                 f"past {MP_LM_TWIN_TOL}")
        first = cases[0]["steps"][0]["loss"]
        if not moe and not abs(first - unsharded) < 5e-3:
            raise AssertionError(f"{path}: first loss {first} vs the "
                                 f"unsharded port's {unsharded}")
        c = cases[0]
        log(f"{path}: {cfg.name} {cfg.family} ({c['params']:,} parameters "
            f"on worker 0) on {dict(edist.mesh.shape)} over "
            f"{MP_NPROC} x {MP_LOCAL} ranks; losses "
            f"{[x['loss'] for x in c['steps']]}, grad norms "
            f"{[x['grad_norm'] for x in c['steps']]}; vs the emulated twin: "
            f"loss, grad norm and every parameter torch.equal at "
            f"{sum(equal)} of {len(equal)} (step, worker) pairs; worst "
            f"relative loss {worst['loss']:.3g}, grad norm "
            f"{worst['grad_norm']:.3g}, parameter abs {worst['param']:.3g} "
            f"(limits {MP_LM_TWIN_TOL}); first loss {first:.6f} vs "
            f"unsharded {unsharded:.6f}; counting processes "
            f"{[x['counts_rows'] for x in cases]}; (step, worker, loss, "
            f"norm, digests equal) {firsts}; twin "
            f"{time.perf_counter() - t0:.1f} s")
        if at_ckpt is not None:
            mp_lm_restores(cfg, edist, opt, batch, os.path.join(
                out_dir, "lm_ckpt"), at_ckpt, (p, state), cases, card)
            at_ckpt = None
        for q, x in enumerate(cases):
            ms, tr = x["split_ms"], x["transport"]
            log(f"  {path} worker {q} [{card}]: steps' host wall "
                f"{[round(s_['wall_ms'], 3) for s_ in x['steps']]} ms; a "
                f"step by CUDA events: forward {ms['fwd']:.3f}, backward "
                f"{ms['bwd']:.3f}, fold {ms['fold']:.3f}, update "
                f"{ms['upd']:.3f} ms, host wall {ms['wall']:.3f} ms; 3 "
                f"steps' gloo {tr['gloo_s']:.3f} s, staging "
                f"{tr['stage_s']:.3f} s, fold {tr['fold_bytes']} B sent, "
                f"exchanges {tr['exchanges']} ({tr['bwd_exchanges']} "
                f"backward), {x['crossing_bytes']} B of activation rows "
                f"across; launches {json.dumps(x['launches'])}; peak "
                f"{x['peak_gb']:.2f} GB; worker {x['seconds']:.1f} s")
        del p, state, params, step
        gc.collect()
        torch.cuda.empty_cache()


def mp_lm_restores(cfg, edist, opt, batch, ckpt_dir, at_ckpt, after,
                   cases, card) -> None:
    """``MP_LM_TRAINER``'s checkpoint in the phase's process: the fleet's
    step-``MP_LM_CKPT_EVERY`` checkpoint restored onto one device (no
    ``dist``) must equal the twin's trees at that step, and restored onto
    the emulated grid one more donating step must equal the twin's next
    step, ``torch.equal`` leaf by leaf. Logs the workers' save and
    restore seconds (gather, write, sha256; sha256, read), the bytes
    written, the resumed run and each process's peak."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.optim.adamw import _leaves as leaves
    from repro_torch.train.steps import make_train_step

    step = MP_LM_CKPT_EVERY
    want = {"params": at_ckpt[0], "opt": at_ckpt[1]}
    one = CheckpointManager(ckpt_dir)
    emu = CheckpointManager(ckpt_dir, dist=edist)
    got = one.restore(step, want)
    bad = [i for i, (a, b) in enumerate(zip(leaves(got), leaves(want)))
           if not torch.equal(a, b)]
    del got
    st = emu.restore(step, want)
    p, s, _ = make_train_step(cfg, edist, opt, donate=True)(
        st["params"], st["opt"], batch)
    nxt = {"params": after[0], "opt": after[1]}
    bad_next = [i for i, (a, b) in enumerate(zip(
        leaves({"params": p, "opt": s}), leaves(nxt)))
        if not torch.equal(a, b)]
    del st, p, s
    gc.collect()
    torch.cuda.empty_cache()
    if bad or bad_next:
        raise AssertionError(
            f"{MP_LM_TRAINER}: the step-{step} checkpoint restored onto one "
            f"device differs from the twin at leaves {bad}; a step from it "
            f"on the emulated grid differs from the twin's next at "
            f"{bad_next}")
    r1, r2 = one.timings[-1], emu.timings[-1]
    log(f"{MP_LM_TRAINER} checkpoint [{card}]: step {step} restored onto one "
        f"device == the twin's params and moments at step {step}, and onto "
        f"the emulated {dict(edist.mesh.shape)} grid + one donating step =="
        f" the twin's step {step + 1}, every leaf torch.equal; the two "
        f"restores one after the other: sha256 {r1['sha256_s']:.2f} / "
        f"{r2['sha256_s']:.2f} s, read + place {r1['read_s']:.2f} / "
        f"{r2['read_s']:.2f} s of {r1['bytes']:,} B")
    for q, c in enumerate(cases):
        k = c["ckpt"]
        for t in k["saves"] + k["timings"]:
            what = (f"save {t['step']}: {t['seconds']:.2f} s (gather "
                    f"{t['gather_s']:.2f}, to the host {t['host_s']:.2f}, "
                    f"write {t['write_s']:.2f} of which sha256 "
                    f"{t['sha256_s']:.2f}), {t['bytes']:,} B written"
                    if t["op"] == "save" else
                    f"restore {t['step']}: {t['seconds']:.2f} s (sha256 "
                    f"{t['sha256_s']:.2f}, read + place {t['read_s']:.2f})")
            log(f"  {MP_LM_TRAINER} worker {q} [{card}]: {what}")
        log(f"  {MP_LM_TRAINER} worker {q}: resumed at step "
            f"{k['first_step']} in {k['seconds']:.1f} s == the uninterrupted"
            f" run (torch.equal); checkpoints {k['all_steps']}; peak "
            f"{c['peak_gb']:.2f} GB on the card, host RSS "
            f"{c['rss_gb']:.1f} GB")


def mp_family_config(args, arch: str, changes: dict):
    """A case of MP_FAMILY_CASES: the published config (``--quick``: the
    smoke config) cut in depth; the hybrid to its first group."""
    from repro_torch.configs import get_config, get_smoke_config

    base = get_smoke_config(arch) if args.quick else get_config(arch)
    if base.family == "hybrid":
        changes = dict(changes, n_layers=base.attn_every)
    return dataclasses.replace(base, **changes)


def mp_family_inputs(args, path: str, dev):
    """A case's config, weights (``torch.Generator`` seed 0 on the card),
    whole batch (numpy seed 0: tokens and the family's frames or patches)
    and the encoder's output (the encdec's, else None)."""
    from repro_torch.models import transformer as TT

    _, arch, changes, tokens = next(c for c in MP_FAMILY_CASES
                                    if c[0] == path)
    cfg = mp_family_config(args, arch, changes)
    batch = _family_inputs(cfg, MP_FAMILY["batch"],
                           min(tokens, 16) if args.quick else tokens,
                           np.random.default_rng(0), dev)
    params = TT.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    enc = None
    if cfg.family == "encdec":
        with torch.no_grad():
            enc = TT._encode(params, cfg, None, batch["enc_embeds"])
    return cfg, params, batch, enc


def mp_family_cell(args, topo, out_dir) -> dict:
    """Phase 12's families on the fleet's grid: for each case of
    MP_FAMILY_CASES and each grid of MP_FAMILY_GRIDS, ``forward`` and one
    ``decode_step`` (this process's rows; the last position's logits
    saved for the twin, bit digests of all), then MP_FAMILY["steps"]
    ``make_train_step`` steps with every parameter's digest after each
    (worker 0 saves the last step's parameters where the twin holds them
    to a tolerance). Returns this process's report."""
    from repro_torch.distributed.context import make_context
    from repro_torch.distributed.topology import Topology
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as TT
    from repro_torch.optim.adamw import AdamWConfig, _leaves, adamw_init
    from repro_torch.train.steps import loss_and_grads, make_train_step

    me, dev = topo.process_index, topo.device
    opt = AdamWConfig(**MP_LM_OPT)
    out = {}
    for path, *_ in MP_FAMILY_CASES:
        gc.collect()
        torch.cuda.empty_cache()
        reset_peak()
        cfg, params, batch, enc = mp_family_inputs(args, path, dev)
        B = MP_FAMILY["batch"]
        for grid in MP_FAMILY_GRIDS:
            t0 = time.perf_counter()
            name = f"{path}_{grid[0]}x{grid[1]}"
            fdist = make_context(Topology.multiprocess(
                device=MP_DEVICE, mesh=make_mesh(grid, ("data", "model"))))
            lo, hi = fdist.local_rows(B)
            with torch.no_grad():
                logits = TT.forward(params, cfg, fdist, batch)
                cache = TT.init_decode_cache(cfg, B, MP_FAMILY["max_len"],
                                             device=dev)
                step_logits, cache = TT.decode_step(
                    params, cfg, fdist, batch["tokens"][:, :1], cache, enc)
            check_finite(step_logits, (hi - lo, 1, cfg.vocab_size),
                         f"{name} decode")
            if not bool(torch.isfinite(logits).all()) or \
                    logits.shape[0] != hi - lo:
                raise AssertionError(f"{name} forward: {logits.shape}")
            torch.save({"forward": logits[:, -1].cpu(),
                        "decode": step_logits[:, -1].cpu()},
                       os.path.join(out_dir, f"{name}.rows.{me}.pt"))
            digests = {"forward": bits_digest(logits),
                       "decode": bits_digest(step_logits)}
            del logits, step_logits, cache
            if grid[0] > 1:
                # the first step's gradient, folded over the data groups
                # (every process takes part in the fold), for the twin's
                # leaf-by-leaf reading
                _, grads = loss_and_grads(params, cfg, fdist, batch)
                folded = fdist.comm.fold_leaves(
                    _leaves(grads), fdist.grad_sources(params, cfg))
                if me == 0:
                    torch.save([g.cpu() for g in folded], os.path.join(
                        out_dir, f"{name}.grads.pt"))
                del grads, folded
            step = make_train_step(cfg, fdist, opt)
            p, state, steps = params, adamw_init(params), []
            for _ in range(MP_FAMILY["steps"]):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                p, state, met = step(p, state, batch)
                torch.cuda.synchronize()
                steps.append({"wall_ms": (time.perf_counter() - t1) * 1e3,
                              "loss": float(met["loss"]),
                              "grad_norm": float(met["grad_norm"]),
                              "digests": [bits_digest(t)
                                          for t in _leaves(p)]})
            if me == 0 and grid[0] > 1:
                with open(os.path.join(out_dir, f"{name}.params.pt"),
                          "wb") as f:
                    torch.save([t.cpu() for t in _leaves(p)], f)
            out[name] = {"grid": list(grid), "span": list(fdist.span),
                         "rows": [lo, hi], "digests": digests,
                         "steps": steps,
                         "params": sum(t.numel() for t in _leaves(params)),
                         "peak_gb": peak_allocated() / 1e9,
                         "seconds": time.perf_counter() - t0}
            del p, state, step, met
        log(f"[worker {me}] {path}: "
            f"{sum(out[k]['seconds'] for k in out if k.startswith(path)):.1f}"
            f" s, peak {peak_allocated() / 1e9:.2f} GB")
        del params, batch, enc
        release_host_memory()
    return out


def mp_family_twin(args, res, out_dir, card: str, dev: str = "cuda") -> None:
    """The emulated twin of phase 12's families, in the phase's own process
    after the workers exit: the same weights, batch and steps on
    ``make_mesh`` of each grid. Where one data group spans the fleet
    ((data 1, model 8)) every worker's forward and decode rows, each
    step's loss and grad norm and every parameter after each step are
    ``torch.equal`` to the twin's; else the last position's logits within
    MP_FAMILY_ROWS_TOL of their largest magnitude, every step's loss, the
    first step's grad norm and the last parameters within MP_LM_TWIN_TOL,
    the first step's folded gradient within MP_FAMILY_GRAD_TOL of the
    twin's leaf by leaf (``family_grad_check``; the second step's grad
    norm, which AdamW's first update makes move, is logged), and the two
    workers' parameters equal to each other's after every step."""
    from repro_torch.distributed.context import make_context
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as TT
    from repro_torch.optim.adamw import AdamWConfig, _leaves, adamw_init
    from repro_torch.train.steps import loss_and_grads, make_train_step

    opt = AdamWConfig(**MP_LM_OPT)
    B = MP_FAMILY["batch"]
    failed = []
    for path, *_ in MP_FAMILY_CASES:
        t_case = time.perf_counter()
        cfg, params, batch, enc = mp_family_inputs(args, path, dev)
        for grid in MP_FAMILY_GRIDS:
            t0 = time.perf_counter()
            name = f"{path}_{grid[0]}x{grid[1]}"
            exact = grid[0] == 1
            edist = make_context(make_mesh(grid, ("data", "model")))
            cases = [r["families"][name] for r in res]
            with torch.no_grad():
                logits = TT.forward(params, cfg, edist, batch)
                cache = TT.init_decode_cache(cfg, B, MP_FAMILY["max_len"],
                                             device=dev)
                step_logits, _ = TT.decode_step(
                    params, cfg, edist, batch["tokens"][:, :1], cache, enc)
            rows_err, rows_equal = 0.0, []
            for q, c in enumerate(cases):
                lo, hi = c["rows"]
                saved = torch.load(os.path.join(out_dir,
                                                f"{name}.rows.{q}.pt"))
                for key, want in (("forward", logits[lo:hi]),
                                  ("decode", step_logits[lo:hi])):
                    last = want[:, -1].float().cpu()
                    err = float((last - saved[key].float()).abs().max()) / \
                        float(last.abs().max())
                    rows_err = max(rows_err, err)
                    rows_equal.append(
                        bits_digest(want) == c["digests"][key]
                        and torch.equal(want[:, -1].cpu(), saved[key]))
            del logits, step_logits, cache
            step = make_train_step(cfg, edist, opt)
            p, state = params, adamw_init(params)
            worst = dict(loss=0.0, grad_norm=0.0, param=0.0)
            later_norm = 0.0  # the steps after the first: logged
            equal = []  # (step, worker): loss, norm and every parameter
            twin_steps = []
            for i in range(MP_FAMILY["steps"]):
                p, state, met = step(p, state, batch)
                loss, norm = float(met["loss"]), float(met["grad_norm"])
                twin_steps.append((round(loss, 6), round(norm, 5)))
                digests = [bits_digest(t) for t in _leaves(p)]
                for c in cases:
                    st = c["steps"][i]
                    dl = abs(st["loss"] - loss) / abs(loss)
                    dn = abs(st["grad_norm"] - norm) / norm
                    worst["loss"] = max(worst["loss"], dl)
                    if i == 0:
                        worst["grad_norm"] = max(worst["grad_norm"], dn)
                    else:
                        later_norm = max(later_norm, dn)
                    equal.append(dl == 0 and dn == 0
                                 and st["digests"] == digests)
                if any(c["steps"][i]["digests"] != cases[0]["steps"][i][
                        "digests"] for c in cases):
                    raise AssertionError(f"{name} step {i + 1}: the workers' "
                                         f"parameters differ")
            steps_seen = [[(round(x["steps"][i]["loss"], 6),
                            round(x["steps"][i]["grad_norm"], 5))
                           for i in range(MP_FAMILY["steps"])]
                          for x in cases]
            if not exact:
                saved = torch.load(os.path.join(out_dir,
                                                f"{name}.params.pt"))
                for t, s_ in zip(_leaves(p), saved):
                    worst["param"] = max(worst["param"], float(
                        (t.float() - s_.to(dev).float()).abs().max()))
                log(f"  {name} steps (loss, grad norm): twin "
                    f"{twin_steps}, workers {steps_seen}")
                worst["grad_leaf"] = family_grad_check(
                    cfg, params, batch, edist, out_dir, name, dev)
            tol = dict(MP_LM_TWIN_TOL, grad_leaf=MP_FAMILY_GRAD_TOL)
            if exact and not (all(rows_equal) and all(equal)):
                failed.append(f"{name}: not torch.equal to the emulated "
                              f"twin: rows {rows_equal}, steps {equal}, "
                              f"worst {worst}")
            if not exact and not (
                    rows_err <= MP_FAMILY_ROWS_TOL
                    and all(worst[k] <= tol[k] for k in worst)):
                failed.append(f"{name}: fleet vs emulated twin rows "
                              f"{rows_err:.3g} (limit {MP_FAMILY_ROWS_TOL}),"
                              f" {worst} (limits {tol})")
            c = cases[0]
            log(f"{name}: {cfg.name} {cfg.family} ({cfg.n_layers} layers"
                + (f" + {cfg.n_enc_layers} encoder" if cfg.n_enc_layers
                   else "")
                + f", {c['params']:,} parameters) on {dict(edist.mesh.shape)}"
                f" over {MP_NPROC} x {MP_LOCAL} ranks, rows "
                f"{[x['rows'] for x in cases]}; forward and decode rows "
                f"torch.equal {sum(rows_equal)} of {len(rows_equal)}, worst "
                f"last-position error {rows_err:.3g} of the largest logit; "
                f"steps' losses {[x['loss'] for x in c['steps']]}, grad "
                f"norms {[x['grad_norm'] for x in c['steps']]}; loss, grad "
                f"norm and every parameter torch.equal at {sum(equal)} of "
                f"{len(equal)} (step, worker) pairs; worst relative loss "
                f"{worst['loss']:.3g}, first grad norm "
                f"{worst['grad_norm']:.3g} (later {later_norm:.3g}, "
                f"logged), first gradient's worst leaf "
                f"{worst.get('grad_leaf', 0.0):.3g}, parameter abs "
                f"{worst['param']:.3g}; worker seconds "
                f"{[round(x['seconds'], 1) for x in cases]}, steps' host wall"
                f" {[[round(s_['wall_ms'], 1) for s_ in x['steps']] for x in cases]}"
                f" ms [{card}], peak {[round(x['peak_gb'], 2) for x in cases]}"
                f" GB; twin {time.perf_counter() - t0:.1f} s")
            del p, state, step, met
        del params, batch, enc
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{path} twin: {time.perf_counter() - t_case:.1f} s")
    if failed:
        raise AssertionError("phase 12 families: " + "; ".join(failed))


def family_grad_check(cfg, params, batch, edist, out_dir, name,
                      dev) -> float:
    """Where a (data 2, model 4) fleet's first-step gradient (folded over
    the data groups, saved by worker 0) leaves the emulated twin's, leaf
    by leaf: logs the norms and the leaves most off, and returns the
    largest ||fleet - twin|| / ||twin|| of a leaf."""
    from repro_torch.optim.adamw import _leaves
    from repro_torch.train.steps import loss_and_grads

    names = list(_leaf_names(params))
    _, eg = loss_and_grads(params, cfg, edist, batch)
    fg = torch.load(os.path.join(out_dir, f"{name}.grads.pt"))

    def norm(ts):
        return math.sqrt(sum(float(t.float().square().sum()) for t in ts))

    rel = []
    for n, e, f in zip(names, _leaves(eg), fg):
        e = e.float()
        rel.append((float((f.to(dev).float() - e).norm()
                          / e.norm().clamp(min=1e-30)), n))
    ne, nf = norm(_leaves(eg)), norm(fg)
    rel.sort(reverse=True)
    log(f"  {name} first-step gradient: norm fleet {nf:.6g}, twin {ne:.6g}"
        f" (relative {abs(nf - ne) / ne:.3g}); leaves most off the twin "
        f"||f - e|| / ||e|| (limit {MP_FAMILY_GRAD_TOL}): "
        f"{[(n, round(r, 4)) for r, n in rel[:4]]}")
    del eg, fg
    gc.collect()
    torch.cuda.empty_cache()
    return rel[0][0]


def mp_train_worker(args) -> None:
    """One process of phase 12: the LM train step (worker 0 replays its
    calls at once), the training cells, the EP LM, then each recorded
    kernel call replayed against its plain version, one process at a
    time. Writes ``<dir>/rank<i>.json``; any failed check raises, and the
    process exits non-zero."""
    import torch.distributed as dist

    from repro_torch.core.sparse import power_law_sparse, random_sparse
    from repro_torch.launch.multiprocess import initialize, shutdown
    from repro_torch.models.gnn import normalize_adjacency

    t_start = time.perf_counter()
    out_dir = args.mp_train_worker
    topo = initialize(timeout=MP_TIMEOUT)
    me = topo.process_index
    if topo.device.type != MP_DEVICE or topo.tiers != (MP_NPROC, MP_LOCAL):
        raise AssertionError(f"worker {me}: topology {topo}")
    torch.backends.cuda.matmul.allow_tf32 = False
    gather = _Gather(out_dir, me, topo.n_hosts)
    # the LM train step first, while the host holds no recorded calls of
    # the cells below (a GCN step's alone fill ~10 GB of host memory), and
    # worker 0's calls of it replayed at once (worker 1 waits at the
    # cells' first collective), so none is held through the cells
    lm_recorded, rows = {}, {}
    lm_train = mp_lm_train_cell(args, topo, lm_recorded, out_dir)
    t0 = time.perf_counter()
    for path in list(lm_recorded):
        calls, launches = lm_recorded.pop(path)
        for k in ("gather_rows", "scatter_add_rows", "rmsnorm",
                  "rmsnorm_bwd"):
            rows.setdefault(k, {})[path] = kernel_row(
                k, calls[k], launches[k], busy=False)
        del calls
    release_host_memory()
    log(f"[worker {me}] LM train calls replayed in "
        f"{time.perf_counter() - t0:.1f} s; host RSS {host_rss_gb():.1f} GB")
    # the hybrid, encdec, vlm and audio families on the fleet's grid, each
    # model released before the next
    t0 = time.perf_counter()
    families = mp_family_cell(args, topo, out_dir)
    log(f"[worker {me}] families: {time.perf_counter() - t0:.1f} s; host "
        f"RSS {host_rss_gb():.1f} GB")
    recorded = {}
    # the cells on a quarter of arxiv (LIFE_SCALE, as phases 8 and 9: the
    # same generators and seeds; cut to keep the script in its limit)
    m = (16_384 if args.quick else M_FULL) // LIFE_SCALE
    nnz = (7 * 16_384 if args.quick else NNZ_FULL) // LIFE_SCALE
    graphs = {"power_law": normalize_adjacency(
                  power_law_sparse(m, m, nnz, 0.8, seed=0)),
              "uniform": normalize_adjacency(
                  random_sparse(m, m, nnz / m ** 2, seed=0))}
    expect = EXPECT_MP_TRAIN["quick" if args.quick else "full"]
    out = {"process": me, "span": list(topo.span), "cells": {},
           "lm_train": lm_train, "families": families}
    for what, graph, kind, path, fields in MP_TRAIN_CELLS:
        t0 = time.perf_counter()
        out["cells"][what] = mp_train_cell(
            args, topo, gather, what, graphs[graph], kind, path, fields,
            expect[what], recorded)
        log(f"[worker {me}] {what}: {time.perf_counter() - t0:.1f} s")
    del graphs
    gc.collect()
    t0 = time.perf_counter()
    out["ep"] = mp_ep_cell(args, topo, gather, recorded)
    log(f"[worker {me}] EP: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["pod"] = mp_pod_cell(args, topo, gather, recorded)
    log(f"[worker {me}] pod grid: {time.perf_counter() - t0:.1f} s")
    # every recorded call against its plain version, one process at a time
    kernels = {"mp_gcn_step": ("gather_rows", "gather_rows_scaled",
                               "scatter_add_rows"),
               "mp_gat_step": ("gather_rows", "gather_rows_scaled",
                               "scatter_add_rows"),
               "mp_ep_prefill": ("gather_rows", "scatter_add_rows",
                                 "rmsnorm"),
               "mp_ep_decode": ("gather_rows", "scatter_add_rows",
                                "rmsnorm"),
               "mp_pod": ("gather_rows", "scatter_add_rows", "rmsnorm")}
    log(f"[worker {me}] host RSS before the replays {host_rss_gb():.1f} GB")
    for turn in range(topo.n_hosts):
        if turn == me:
            t0 = time.perf_counter()
            for path, names in kernels.items():
                calls, launches = recorded.pop(path)
                for k in names:
                    rows.setdefault(k, {})[path] = kernel_row(
                        k, calls[k], launches[k], busy=False)
                del calls
                gc.collect()
                torch.cuda.empty_cache()
            log(f"[worker {me}] kernel calls replayed in "
                f"{time.perf_counter() - t0:.1f} s")
        dist.barrier()
    out["kernels"] = rows
    out["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"rank{me}.json"), "w") as f:
        json.dump(out, f, default=lambda o: o.item())  # numpy scalars
    shutdown()


def mp_train_phase(args, card: str) -> dict:
    """Phase 12: training and the EP LM across 2 processes × 4 ranks on
    the card (``mp_train_worker``). Logs each cell's checks and times
    and returns the kernel rows of the mp_gcn_step, mp_gat_step,
    mp_ep_prefill and mp_ep_decode paths (worker 0's numbers, the worst
    error of both)."""
    import shutil

    from repro_torch.launch.multiprocess import launch_local

    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "mp_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    rc = launch_local(MP_NPROC, MP_LOCAL, timeout=MP_TRAIN_TIMEOUT,
                      device=MP_DEVICE,
                      argv=[sys.executable, os.path.abspath(__file__),
                            "--mp-train-worker", out_dir]
                      + (["--quick"] if args.quick else []))
    if rc:
        raise AssertionError(f"phase 12: a worker failed (exit {rc})")
    res = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
           for r in range(MP_NPROC)]
    for what, _, kind, _, _ in MP_TRAIN_CELLS:
        cells = [r["cells"][what] for r in res]
        d, emu = cells[0], cells[0]["emulated"]
        log(f"{what} decisions (== the reference's): "
            f"{json.dumps(d['decisions'])}; prep {d['prep_s']:.1f} s")
        log(f"  dB of ½‖h‖²: every process's rows == the emulated run's; "
            f"rows (fwd, bwd) {d['db_rows']}, across processes "
            f"{d['db_crossing']} (plan {d['plan_crossing']})")
        log(f"  first step: loss {d['losses'][0]:.6f} (emulated "
            f"{emu['losses'][0]:.6f}); every gradient within rtol 2e-3 / "
            f"atol 2e-4 of the emulated run's (max err / tol "
            f"{emu['grad_err_over_tol']:.3g}); rows a step (fwd, bwd) "
            f"{d['rows']}, across processes {d['crossing']}; launches "
            f"{json.dumps(d['launches'])}; op watch clean")
        log(f"  {d['epochs']} epochs: losses "
            f"{[round(x, 6) for x in d['losses']]} (emulated "
            f"{[round(x, 6) for x in emu['losses']]}); "
            f"parameters equal on both processes after every step")
        for r, cell in zip(res, cells):
            md = cell["median"]
            log(f"  {what} worker {r['process']} [{card}]: per epoch "
                f"(median of {cell['epochs'] - 1}) forward {md['fwd']:.3f} "
                f"ms, backward {md['bwd']:.3f} ms, update {md['upd']:.3f} ms"
                f" by CUDA events, {md['wall']:.3f} ms host wall; gloo "
                f"{md['gloo']:.3f} ms, staging {md['stage']:.3f} ms, "
                f"{md['exchanges']:.0f} exchanges, {md['staged_bytes']:.0f} B"
                f" staged")
        me_ = emu["median"]
        log(f"  {what} on Topology.local(8) [{card}]: forward "
            f"{me_['fwd']:.3f} ms, backward {me_['bwd']:.3f} ms, update "
            f"{me_['upd']:.3f} ms, {me_['wall']:.3f} ms host wall")
    ep = [r["ep"] for r in res]
    e = ep[0]
    log(f"mp-olmoe-serve-ep: grid {e['grid']}, worker spans "
        f"{[x['span'] for x in ep]}, model ranks "
        f"{[x['model_ranks'] for x in ep]}; weights on the card "
        f"{[round(x['weights_gb'], 2) for x in ep]} GB")
    log(f"  prefill {LM_PREFILL[0]}x{LM_PREFILL[1]}: cap {e['cap']}, cap_e "
        f"{e['cap_e']}; activation rows {e['activation_rows']} = 2·L·Dsz·M·M"
        f"·cap; across processes {e['crossing_rows']} rows = "
        f"{e['crossing_bytes']} B; dropped per layer {e['dropped']}; "
        f"launches {json.dumps(e['prefill_launches'])} / decode "
        f"{json.dumps(e['decode_launches'])}; logits equal on both processes")
    same = e["tokens"] == e["emulated_tokens"]
    log(f"  bf16 tokens (prefill's last position, one decode step) == the "
        f"emulated (data 1, model 8) run's: {same}")
    b = e["batcher"]
    log(f"  batcher: served {b['served']}, {b['tokens']} tokens in "
        f"{b['steps']} steps, the same tokens on both processes; "
        f"{b['tokens_per_s']:.2f} tokens/s [{card}] ({b['wall_s']:.2f} s "
        f"host wall)")
    for r, x in zip(res, ep):
        for key in ("prefill", "decode"):
            dev_ms, host_ms = x[f"{key}_ms"]
            log(f"  EP {key} worker {r['process']} [{card}]: median of 3: "
                f"{dev_ms:.3f} ms device events, {host_ms:.3f} ms host wall;"
                f" gloo {x[f'{key}_gloo_ms']:.3f} ms, staging "
                f"{x[f'{key}_stage_ms']:.3f} ms")
    f = e["f32"]
    log(f"  float32 copy: fleet vs emulated (data 1, model 8) "
        f"{f['vs_emulated']}; vs _moe_dense at capacity 8.0 "
        f"{f['vs_dense']}; seq-shard decode vs unsharded {f['seq_shard']}; "
        f"decode vs forward {f['decode_vs_forward']}; dropped at the "
        f"published capacity {f['dropped']} == the emulated run's; the "
        f"model ranks' outputs bit-identical across the processes")
    rows = {}
    for k, per_path in res[0]["kernels"].items():
        for path, row in per_path.items():
            other = [r["kernels"][k][path] for r in res[1:]
                     if path in r["kernels"].get(k, {})]
            launches = [row["launches"]] + [o["launches"] for o in other]
            if path in res[0]["lm_train"]:  # replayed on worker 0 alone
                launches = [r["lm_train"][path]["launches"][k] for r in res]
            rows.setdefault(k, {})[path] = dict(
                row, max_abs_err=max([row["max_abs_err"]]
                                     + [o["max_abs_err"] for o in other]),
                launches_per_worker=launches)
    pods = [r["pod"] for r in res]
    log(f"mp_pod: (pod 2, data 2, model 2) over {MP_NPROC} x {MP_LOCAL} "
        f"ranks, batch rows {[x['rows'] for x in pods]} (groups "
        f"{[x['groups'] for x in pods]}): prefill {MP_POD['batch']}x"
        f"{MP_POD['seq']} and one decode step vs the emulated grid, bf16 "
        f"torch.equal {[(x['prefill']['equal'], x['decode']['equal']) for x in pods]}"  # noqa: E501
        f", max err {[(x['prefill']['max_err'], x['decode']['max_err']) for x in pods]}"  # noqa: E501
        f" (limit {MP_FAMILY_ROWS_TOL} of {[x['prefill']['scale'] for x in pods]})")  # noqa: E501
    for r, x in zip(res, pods):
        log(f"  mp_pod worker {r['process']} [{card}]: prefill "
            f"{x['prefill_ms'][0]:.3f} ms events / {x['prefill_ms'][1]:.3f} "
            f"ms host, decode {x['decode_ms'][0]:.3f} / "
            f"{x['decode_ms'][1]:.3f} ms; gloo {x['transport']['gloo_s']:.3f}"
            f" s, {x['transport']['exchanges']} exchanges; launches "
            f"{json.dumps(x['launches'])}; float32 copy: forward "
            f"{x['f32']['forward']} (torch.equal {x['f32']['forward_equal']}"
            f"), decode {x['f32']['decode']} (torch.equal "
            f"{x['f32']['decode_equal']})")
    # the ragged grid, in a launch of its own (2 processes x 3 ranks)
    t0 = time.perf_counter()
    rc = launch_local(MP_RAGGED["nproc"], MP_RAGGED["local"],
                      timeout=MP_TIMEOUT, device=MP_DEVICE,
                      argv=[sys.executable, os.path.abspath(__file__),
                            "--mp-ragged-worker", out_dir]
                      + (["--quick"] if args.quick else []))
    if rc:
        raise AssertionError(f"phase 12: a ragged worker failed (exit {rc})")
    ragged = [json.load(open(os.path.join(out_dir, f"ragged{r}.json")))
              for r in range(MP_RAGGED["nproc"])]
    for k, per_path in ragged[0]["kernels"].items():
        rows.setdefault(k, {})["mp_ragged_train"] = dict(
            per_path["mp_ragged_train"],
            launches_per_worker=[r["launches"][k] for r in ragged])
    mp_ragged_twin(args, ragged, out_dir, card)
    log(f"phase 12 ragged launch and its twin: "
        f"{time.perf_counter() - t0:.1f} s")
    t_twin = time.perf_counter()
    mp_lm_twin(args, res, out_dir, card)
    cases_s = [round(sum(c["seconds"] for c in r["lm_train"].values()), 1)
               for r in res]
    log(f"phase 12 LM train twin: {time.perf_counter() - t_twin:.1f} s; "
        f"the LM train cases on the workers {cases_s} s")
    t_twin = time.perf_counter()
    mp_family_twin(args, res, out_dir, card)
    log(f"phase 12 families twin: {time.perf_counter() - t_twin:.1f} s; "
        f"the families on the workers "
        f"{[round(sum(c['seconds'] for c in r['families'].values()), 1) for r in res]} s")
    shutil.rmtree(out_dir, ignore_errors=True)
    log(f"phase 12 training and EP across processes: "
        f"{time.perf_counter() - t_phase:.1f} s (workers "
        f"{[round(r['seconds'], 1) for r in res]} s)")
    return rows


# ---------------------------------------------------------------------------
# phase 13: LM training — OLMoE-1B-7B dense and expert-parallel, smollm-135m
# through the training launcher
# ---------------------------------------------------------------------------

TRAIN_LM = dict(arch="olmoe-1b-7b", layers=2, batch=8, seq=128, steps=5)
# AdamW of the 5 steps on one repeated batch (the reference launcher's lr)
TRAIN_LM_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=5,
                    schedule="constant")
TRAIN_LM_F32 = dict(batch=2, seq=128)  # the float32 / float64 grads' batch
TRAIN_LM_EP_EXACT = 8.0  # the EP capacity at which nothing drops
SMOLLM_TRAIN = dict(batch=8, seq=256, steps=30, ckpt_every=10)


class host_map_watch:
    """Counts the backward maps built on the host (``ops._cached``)."""

    def __enter__(self):
        from repro_torch.kernels import ops

        self.built, self.orig = [], ops._cached

        def counted(key, kind, build):
            self.built.append(kind)
            return self.orig(key, kind, build)

        ops._cached = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops._cached = self.orig


def _events(n: int):
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def split_train_step(cfg, dist, opt, params, state, batch, sources=None):
    """``make_train_step(..., donate=True)``'s step (one microbatch) with
    CUDA events around its forward (``lm_loss``), backward and AdamW
    update (in place: it consumes ``params`` and ``state`` and returns
    them) and the host wall around the whole: (params, state, metrics,
    {fwd, bwd, upd, wall} ms). On a fleet (``sources``:
    ``dist.grad_sources``) the fold of the gradients and the loss is
    timed too ("fold")."""
    from repro_torch.models.transformer import lm_loss
    from repro_torch.optim.adamw import _leaves, _rebuild, adamw_update

    keys = ("fwd", "bwd") + (("fold",) if sources else ()) + ("upd",)
    ev = _events(len(keys) + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    loss = lm_loss(_rebuild(params, iter(leaves)), cfg, dist, batch)
    ev[1].record()
    grads = torch.autograd.grad(loss, leaves)
    ev[2].record()
    if sources:
        grads = dist.comm.fold_leaves(list(grads), sources)
        loss = dist.comm.fold(loss.detach())
        ev[3].record()
    params, state, metrics = adamw_update(
        opt, params, _rebuild(params, iter(grads)), state,
        None if dist is None else dist.grad_shards(params, cfg),
        donate=True)
    ev[-1].record()
    torch.cuda.synchronize()
    metrics["loss"] = loss.detach()
    ms = {k: ev[i].elapsed_time(ev[i + 1]) for i, k in enumerate(keys)}
    ms["wall"] = (time.perf_counter() - t0) * 1e3
    return params, state, metrics, ms


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_names(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1]


def check_all_grads(grads, what: str) -> None:
    """Every leaf's gradient finite and not all zero."""
    from repro_torch.optim.adamw import _leaves

    bad = [n for n, g in zip(_leaf_names(grads), _leaves(grads))
           if not bool(torch.isfinite(g).all()) or not bool(g.abs().sum() > 0)]
    if bad:
        raise AssertionError(f"{what}: non-finite or all-zero gradient for "
                             f"{bad}")


def train_lm_cell(what, cfg, dist, params, batch, card, measure=None):
    """Five ``make_train_step`` steps on one repeated batch, counted from
    0 (every K1 / K2 / K6 / K6-backward launch; no backward map built on
    the host), then the same five through ``split_train_step`` timed:
    both end on the same parameters bit for bit, and the loss falls.
    With ``measure`` the timed five are phase 16's cell of that name.
    Returns (launches, losses, the split medians, the last params)."""
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import (
        AdamWConfig, _leaves, _map, adamw_init,
    )
    from repro_torch.train.steps import make_train_step

    opt = AdamWConfig(**TRAIN_LM_OPT)
    step = make_train_step(cfg, dist, opt)  # functional: params stay
    p, state, losses = params, adamw_init(params), []
    ops.reset_launch_counts()
    with host_map_watch() as maps:
        for _ in range(TRAIN_LM["steps"]):
            p, state, m = step(p, state, batch)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"{what}: 5 steps' launches {json.dumps(launches)}; losses "
        f"{[round(x, 4) for x in losses]}; host-built backward maps "
        f"{len(maps.built)}")
    want = ("gather_rows", "scatter_add_rows", "rmsnorm", "rmsnorm_bwd")
    if min(launches[k] for k in want) < 1 or maps.built:
        raise AssertionError(f"{what}: a kernel was not launched or a map "
                             f"was built on the host: {launches}, "
                             f"{maps.built}")
    per_step = 2 * cfg.n_layers + 1
    if launches["rmsnorm_bwd"] != TRAIN_LM["steps"] * per_step:
        raise AssertionError(f"{what}: K6's backward launched "
                             f"{launches['rmsnorm_bwd']} times (want "
                             f"{TRAIN_LM['steps']} x {per_step})")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the loss did not fall: {losses}")
    first = p
    del state, m
    # the timed run donates: it updates a copy of the initial parameters
    start = _map(torch.clone, params)

    def timed():
        p, state, times = start, adamw_init(start), []
        placed = tensor_bytes(start, state, batch)
        for _ in range(TRAIN_LM["steps"]):
            p, state, m, ms = split_train_step(cfg, dist, opt, p, state,
                                               batch)
            times.append(ms)
        med = {k: statistics.median(t[k] for t in times[1:])
               for k in times[0]}
        return ((p, med), med["fwd"] + med["bwd"] + med["upd"],
                "median of steps 2-5, forward + backward + update by CUDA "
                "events", placed)

    if measure:
        p, med = measure_step(measure, cfg, batch["tokens"].shape[1],
                              batch["tokens"].shape[0], "train", timed,
                              tensor_bytes(start, batch))
    else:
        (p, med), *_ = timed()
    if p is not start:
        raise AssertionError(f"{what}: the donating steps returned another "
                             f"tree")
    for a, b in zip(_leaves(first), _leaves(p)):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: the donating 5-step run differs "
                                 f"from the functional one")
    del start
    tokens = batch["tokens"].numel()
    step_ms = med["fwd"] + med["bwd"] + med["upd"]
    log(f"{what} [{card}]: 5 donating steps == 5 functional steps, bit for "
        f"bit; a step (median of steps 2-5): forward {med['fwd']:.3f} ms, "
        f"backward {med['bwd']:.3f} ms, update {med['upd']:.3f} ms (CUDA "
        f"events; AdamW in place {med['upd'] / step_ms:.3f} of the step, "
        f"F2's functional update 74.956 of 115.784 ms = 0.647 on the dense "
        f"step), host wall {med['wall']:.3f} ms; "
        f"{tokens / med['wall'] * 1e3:.1f} tokens/s")
    return launches, losses, med, p


def watched_step(what, cfg, dist, params, batch):
    """One forward + backward inside ``library_watch``: no index_add /
    scatter_add / accumulating index_put / plain version, and backward
    ops seen."""
    from repro_torch.models.transformer import lm_loss
    from repro_torch.optim.adamw import _leaves, _rebuild

    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    with library_watch() as watch:
        loss = lm_loss(_rebuild(params, iter(leaves)), cfg, dist, batch)
        torch.cuda.synchronize()
        watch.stage = "backward"
        torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
    watch.check(what)
    log(f"{what}: op watch clean ({sum(watch.seen.values())} ops, "
        f"{sum(n for (st, _), n in watch.seen.items() if st == 'backward')} "
        f"in the backward)")


def recorded_grads(cfg, dist, params, batch):
    """The kernel calls of one forward + backward, their arguments kept in
    host memory until each is replayed (``record_kernel_calls``): the
    replays run outside autograd, after the counted runs."""
    from repro_torch.train.steps import loss_and_grads

    return record_kernel_calls(
        lambda: loss_and_grads(params, cfg, dist, batch), host=True)


def check_grad_close(got, want, what: str, rtol: float, atol: float) -> float:
    """Every leaf within rtol / atol; returns the worst error over its
    tolerance (<= 1 passes)."""
    from repro_torch.optim.adamw import _leaves

    overs = []
    for name, g, w in zip(_leaf_names(got), _leaves(got), _leaves(want)):
        g, w = g.double(), w.double()
        overs.append((((g - w).abs() / (atol + rtol * w.abs())).max().item(),
                      name, w.abs().max().item()))
    bad = [o for o in overs if not o[0] <= 1.0]
    if bad:
        raise AssertionError(
            f"{what}: {len(bad)} of {len(overs)} leaves off their tolerance;"
            f" the worst (x tolerance, leaf, max |want|): "
            f"{sorted(bad, reverse=True)[:6]}")
    return max(o[0] for o in overs)


def grad_rel_errors(got, want):
    """For each leaf: (||got - want|| / ||want||, its name, its worst
    element-wise error over GRAD_TOL), the largest first."""
    from repro_torch.optim.adamw import _leaves

    out = []
    for name, g, w in zip(_leaf_names(got), _leaves(got), _leaves(want)):
        g, w = g.double(), w.double()
        out.append(((g - w).norm().item() / w.norm().item(), name,
                    ((g - w).abs() / (GRAD_TOL["atol"] + GRAD_TOL["rtol"]
                                      * w.abs())).max().item()))
    return sorted(out, reverse=True)


def train_lm_f32(cfg, dist, params, dev: str) -> None:
    """The float32 checks on a copy of the model: first-step grads within
    rtol 2e-3 / atol 2e-4 of a float64 run (the plain versions), the EP
    grads at capacity 8.0 within 2e-4 of the dense path's, and
    ``microbatches=2``'s step within the same tolerances of one batch (its
    first moments, 0.1 x the accumulated grads)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as TT
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.steps import loss_and_grads, make_train_step

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = TT._tree_map(lambda t: t.float(), params)
    toks = SyntheticLM(cfg.vocab_size, TRAIN_LM_F32["seq"],
                       TRAIN_LM_F32["batch"], seed=0).batch(0)["tokens"]
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    loss32, g32 = loss_and_grads(p32, cfg32, None, batch)
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    p64 = TT._tree_map(lambda t: t.double(), p32)
    with plain_kernels():
        loss64, g64 = loss_and_grads(p64, cfg64, None, batch)
    del p64
    worst = check_grad_close(g32, g64, "float32 grads vs float64",
                             **GRAD_TOL)
    log(f"  float32 copy ({cfg.n_layers} layers, {toks.shape[0]}x"
        f"{toks.shape[1]}): loss {float(loss32):.6f} vs float64 "
        f"{float(loss64):.6f}; first-step grads within rtol 2e-3 / atol "
        f"2e-4 of float64 (worst {worst:.3g} of the tolerance)")
    del g64
    ep_cfg = dataclasses.replace(cfg32, capacity_factor=TRAIN_LM_EP_EXACT)
    with host_map_watch() as maps:
        _, gep = loss_and_grads(p32, ep_cfg, dist, batch)
    worst = check_grad_close(gep, g32, "EP vs dense (capacity 8.0)",
                             rtol=2e-4, atol=2e-4)
    if maps.built:
        raise AssertionError(f"EP grads built maps on the host: {maps.built}")
    log(f"  float32 EP at capacity {TRAIN_LM_EP_EXACT} vs _moe_dense: "
        f"grads within 2e-4 (worst {worst:.3g} of the tolerance)")
    del gep, g32
    opt = AdamWConfig(**TRAIN_LM_OPT)
    outs = []
    for mb in (1, 2):
        _, st, m = make_train_step(cfg32, None, opt, microbatches=mb)(
            p32, adamw_init(p32), batch)
        outs.append((st["m"], float(m["loss"]), float(m["grad_norm"])))
        del st
    worst = check_grad_close(outs[1][0], outs[0][0], "microbatches=2",
                             rtol=GRAD_TOL["rtol"],
                             atol=GRAD_TOL["atol"] * (1 - 0.9))
    for i, k in ((1, "loss"), (2, "grad_norm")):
        if not abs(outs[1][i] - outs[0][i]) <= GRAD_TOL["rtol"] * abs(
                outs[0][i]):
            raise AssertionError(f"microbatches=2: {k} {outs[1][i]} vs "
                                 f"{outs[0][i]}")
    log(f"  microbatches=2 vs 1: loss {outs[1][1]:.6f} / {outs[0][1]:.6f}, "
        f"grad_norm {outs[1][2]:.6f} / {outs[0][2]:.6f}, first moments "
        f"within tolerance (worst {worst:.3g})")


def smollm_train(args, card, dev: str = "cuda") -> dict:
    """Phase 13b: ``launch/train.py --arch smollm-135m --full`` on the
    card, 30 steps at 8 x 256 with checkpoints at 10, 20 and 30; the
    step-30 checkpoint deleted, the run resumed from 20 to 30 ends with
    the parameters of the uninterrupted run, ``torch.equal``."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train as LT
    from repro_torch.optim.adamw import _leaves

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "phase13_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    c = SMOLLM_TRAIN
    seq = 16 if args.quick else c["seq"]
    run = ["--arch", "smollm-135m", "--device", dev, "--batch",
           str(c["batch"]), "--seq", str(seq), "--steps", str(c["steps"]),
           "--ckpt-every", str(c["ckpt_every"]), "--ckpt-dir", root] + \
        ([] if args.quick else ["--full"])
    ckpt = CheckpointManager(root)
    try:
        whole = LT.main(run)
        t1 = time.perf_counter()
        steps = ckpt.all_steps()
        shutil.rmtree(ckpt._step_dir(c["steps"]))
        resumed = LT.main(run)
        t2 = time.perf_counter()
        steps_after = ckpt.all_steps()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    start = c["steps"] - c["ckpt_every"]
    want = list(range(c["ckpt_every"], c["steps"] + 1, c["ckpt_every"]))
    if whole["last_step"] != c["steps"] or \
            resumed["last_step"] != c["steps"] or \
            resumed["history"][0]["step"] != start or \
            steps != want or steps_after != want:
        raise AssertionError(f"smollm-train: steps {whole['last_step']}, "
                             f"{resumed['last_step']} (resumed history "
                             f"{resumed['history']}), checkpoints {steps}, "
                             f"{steps_after}")
    for a, b in zip(_leaves(resumed["params"]), _leaves(whole["params"])):
        if not torch.equal(a, b):
            raise AssertionError("smollm-train: the resumed run's params "
                                 "differ from the uninterrupted run's")
    losses = [h["loss"] for h in whole["history"] + resumed["history"]]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"smollm-train: non-finite loss {losses}")
    events = whole["straggler_events"] + resumed["straggler_events"]
    log(f"smollm-train [{card}]: {c['steps']} steps (checkpoints {steps}), "
        f"the last deleted and the run resumed from {start}: == the "
        f"uninterrupted run, bit for bit; logged losses "
        f"{[round(x, 4) for x in losses]}; straggler events {events}; "
        f"host seconds: whole {t1 - t0:.1f}, resume {t2 - t1:.1f} "
        f"(checkpoints included)")
    return whole


def train_lm_phase(args, card: str, dev: str = "cuda") -> dict:
    """Phase 13: LM training on the card. Returns the kernel paths for
    the JSON rows ({kernel: {path: row}})."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.context import make_context
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as TT
    from repro_torch.train.steps import loss_and_grads

    t_phase = time.perf_counter()
    reset_peak()
    base = get_smoke_config(TRAIN_LM["arch"]) if args.quick else \
        get_config(TRAIN_LM["arch"])
    cfg = dataclasses.replace(base, n_layers=TRAIN_LM["layers"])
    params = TT.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"olmoe-train: {cfg.name} at its published width, {cfg.n_layers} "
        f"of {base.n_layers} layers ({cfg.dtype}, d_model {cfg.d_model}, "
        f"{cfg.n_experts} experts top-{cfg.top_k}, remat {cfg.remat}): "
        f"{n_params:,} parameters, random (torch.Generator({dev!r}) seed 0)")
    toks = SyntheticLM(cfg.vocab_size, TRAIN_LM["seq"], TRAIN_LM["batch"],
                       seed=0).batch(0)["tokens"]
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    dist = make_context(make_mesh(*EP_GRID))

    # every leaf's first-step gradient, dense and EP (the detached K6
    # left the norm gains and the earlier layers without one)
    for what, d in (("dense", None), ("EP", dist)):
        _, grads = loss_and_grads(params, cfg, d, batch)
        check_all_grads(grads, f"olmoe-train {what}")
        del grads
    log("olmoe-train: every leaf's gradient finite and non-zero, dense and "
        "EP")

    # the kernel calls of one step, replayed against the plain versions
    # below
    dense_calls = recorded_grads(cfg, None, params, batch)
    ep_calls = recorded_grads(cfg, dist, params, batch)
    for what, d in (("olmoe-train dense", None), ("olmoe-train EP", dist)):
        watched_step(what, cfg, d, params, batch)

    # the counted runs, twice each, timed
    dense_n, _, dense_ms, _ = train_lm_cell("olmoe-train dense", cfg, None,
                                            params, batch, card,
                                            measure="olmoe_train")
    ep_n, _, ep_ms, _ = train_lm_cell("olmoe-train EP", cfg, dist, params,
                                      batch, card)
    train_lm_f32(cfg, dist, params, dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"peak device memory, phase 13a: "
        f"{peak_allocated() / 2 ** 30:.2f} GiB")

    t0 = time.perf_counter()
    reset_peak()
    whole = smollm_train(args, card, dev)
    scfg = get_smoke_config("smollm-135m") if args.quick else \
        get_config("smollm-135m")
    sbatch = {"tokens": torch.from_numpy(SyntheticLM(
        scfg.vocab_size, 16 if args.quick else SMOLLM_TRAIN["seq"],
        SMOLLM_TRAIN["batch"]).batch(0)["tokens"]).to(dev)}
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    def timed():
        p, st, times = whole["params"], adamw_init(whole["params"]), []
        placed = tensor_bytes(p, st, sbatch)
        for _ in range(3):
            p, st, _, ms = split_train_step(scfg, None, AdamWConfig(), p, st,
                                            sbatch)
            times.append(ms)
        med = {k: statistics.median(t[k] for t in times[1:])
               for k in times[0]}
        return ((p, st, med), med["fwd"] + med["bwd"] + med["upd"],
                "median of steps 2-3, forward + backward + update by CUDA "
                "events", placed)

    p, st, med = measure_step(
        "smollm_train", scfg, sbatch["tokens"].shape[1],
        sbatch["tokens"].shape[0], "train", timed,
        tensor_bytes(whole["params"], sbatch))
    log(f"smollm-train [{card}]: a donating step (median of steps 2-3, "
        f"{scfg.n_layers} layers, remat {scfg.remat}): forward "
        f"{med['fwd']:.3f} ms, backward {med['bwd']:.3f} ms, update "
        f"{med['upd']:.3f} ms (CUDA events; AdamW in place "
        f"{med['upd'] / (med['fwd'] + med['bwd'] + med['upd']):.3f} of the "
        f"step), host wall {med['wall']:.3f} "
        f"ms; {sbatch['tokens'].numel() / med['wall'] * 1e3:.1f} tokens/s; "
        f"peak device memory {peak_allocated() / 2 ** 30:.2f} GiB; phase "
        f"13b {time.perf_counter() - t0:.1f} s")
    # one more step, counted from 0, its kernel calls recorded (path
    # train_smollm: 2048 rows of 576)
    ops.reset_launch_counts()
    smollm_calls = record_kernel_calls(lambda: split_train_step(
        scfg, None, AdamWConfig(), p, st, sbatch), host=True)
    smollm_n = ops.launch_counts()
    log(f"smollm-train: one step's launches {json.dumps(smollm_n)}")
    del whole, p, st
    gc.collect()
    torch.cuda.empty_cache()

    # every recorded call against its plain version; launches: the 5
    # counted steps' (the replays are not counted)
    rows = {}
    paths = (("train_dense", dense_calls, dense_n),
             ("train_ep", ep_calls, ep_n),
             ("train_smollm", smollm_calls, smollm_n))
    for path, calls, n in paths:
        for k, c in calls.items():
            if c:
                rows.setdefault(k, {})[path] = kernel_row(k, c, n[k])
    del dense_calls, ep_calls, smollm_calls
    for k in ("rmsnorm", "rmsnorm_bwd"):
        for path, _, _ in paths:
            r = rows[k][path]
            log(f"K6 {'backward' if k.endswith('bwd') else 'forward'} on "
                f"{path} [{card}]: {r['ms']:.4f} ms a step over "
                f"{r['calls_per_h']} calls, busy "
                f"{r['kernel_busy_ms'] / r['kernel_busy_calls']:.5f} ms a "
                f"call {json.dumps(r['kernel_busy_ms_by_kernel'])} over "
                f"{r['kernel_busy_calls']}, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library "
                f"({'F.rms_norm autograd backward' if k.endswith('bwd') else 'F.rms_norm'}) "
                f"{r['library_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"host {r['host_us_per_launch']:.2f} us a call")
    log(f"phase 13 LM training: {time.perf_counter() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phases 14 and 15: the SSM, hybrid, encdec and prefix families at full
# width, each model served by ``family_serve``
# ---------------------------------------------------------------------------

# phase 14's cell (arch, path prefix, prefill tokens a prompt): 256 tokens
# are two of the config's 128-token scan chunks (h carried)
SSM_CELL = ("falcon-mamba-7b", "ssm", 256)


def k6_launch_lanes(rows: int, d: int, element_size: int) -> int:
    """The lanes a row of K6's forward launch gets (``rmsnorm_kernel_rows``;
    the C launcher's rule): ``_fwd_layout``'s, doubled while a lane would
    hold more than 3 16-byte chunks or rows · lanes < 2**16, at most 256."""
    from repro_torch.kernels.rmsnorm import _fwd_layout

    nvec = -(-d // (16 // element_size))
    lanes = _fwd_layout(d, element_size)
    while lanes < 256 and (-(-nvec // lanes) > 3 or rows * lanes < 1 << 16):
        lanes *= 2
    return lanes


# phase 15's cells (arch, path prefix, prefill tokens a prompt): zamba2's 256 tokens are
# two of its 128-token scan chunks; seamless's 128 decoder tokens attend
# to its published 1024 encoder frames (frontend_len: the encoder's
# attention takes flash, non-causal); llava's 448 tokens after its 576
# patches make 1024 positions (flash, causal)
FAMILY_CELLS = (("zamba2-2.7b", "hybrid", 256),
                ("seamless-m4t-medium", "encdec", 128),
                ("llava-next-mistral-7b", "vlm", 448))
FAMILY_BATCH = 8
# the families whose prefill phase 16 holds the dry run against
DRYRUN_PREFILLS = ("hybrid", "encdec", "vlm")
# phases 14 and 15's timed prefills: 3 samples, cut from 7 to
# keep the script inside its limit (zamba2's and falcon-mamba's prefills
# take ~2.8-2.9 s a sample)
FAMILY_PREFILL_REPS = 3
# zamba2's float32 copy and its train check: the first 12 layers, 2
# groups of attn_every 6, so the shared block is applied twice
HYBRID_CUT = 12
FAMILY_TRAIN = dict(batch=8, seq=128, steps=3)
FAMILY_TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=3,
                        schedule="constant")
# the float32 copy's first-step grads against float64: at 12 layers of
# zamba2 float32 run op by op is ~1e-3 off float64 norm-wise and misses
# rtol 2e-3 / atol 2e-4 element-wise, the reference's op-by-op float32
# as far as the port's (scripts/reference_hybrid_grads.py); each leaf is
# held norm-wise to the rtol, ||g32 - g64|| <= 2e-3 ||g64||, with the
# element-wise figure and a bf16 control logged
FAMILY_TRAIN_F32 = dict(batch=2, seq=128)


def k6_per_step(cfg, cross: bool = False, encoder: bool = False) -> int:
    """K6 launches of one forward or decode step: every block's norms
    (``cross``: the encdec decoder's ln3 too), the encoder's blocks and
    final norm (``encoder``), the model's final norm."""
    if cfg.family == "ssm":  # ln1 a block
        return cfg.n_layers + 1
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        return groups * cfg.attn_every + 2 * groups + 1
    n = cfg.n_layers * (3 if cross else 2) + 1
    return n + (2 * cfg.n_enc_layers + 1 if encoder else 0)


class flash_watch:
    """Within the block, each ``flash_attention`` call is counted by
    (causal, device type, q shape)."""

    def __enter__(self):
        from repro_torch.models import layers

        self.calls, self.orig = collections.Counter(), layers.flash_attention

        def counted(q, k, v, *, causal=True, **kw):
            self.calls[(bool(causal), q.device.type, tuple(q.shape))] += 1
            return self.orig(q, k, v, causal=causal, **kw)

        layers.flash_attention = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers

        layers.flash_attention = self.orig


def _family_inputs(cfg, b: int, s: int, rng, dev: str) -> dict:
    """Tokens [b, s] and the family's frames / patches [b, frontend_len,
    d_model] (drawn in float32 from ``rng``, placed in the model's dtype,
    as ``launch/specs.py``'s stand-ins are: the forward's cast to it
    rounds the same), on ``dev``."""
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).to(dev)}
    if cfg.frontend is not None:
        key = "enc_embeds" if cfg.family == "encdec" else "prefix_embeds"
        out[key] = torch.from_numpy(rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model), dtype=np.float32)).to(
                dev, getattr(torch, cfg.dtype))
    return out


def _cut(params: dict, cfg, n_layers: int, n_enc: int = 0) -> dict:
    """The model's first ``n_layers`` decoder layers (and ``n_enc``
    encoder layers), every other leaf whole: views of ``params``."""
    from repro_torch.models import transformer as TT

    out = {k: v for k, v in params.items() if k not in ("layers", "encoder")}
    out["layers"] = TT._tree_map(lambda t: t[:n_layers], params["layers"])
    if "encoder" in params:
        out["encoder"] = {
            "layers": TT._tree_map(lambda t: t[:n_enc],
                                   params["encoder"]["layers"]),
            "norm": params["encoder"]["norm"]}
    return out


def family_serve(args, card: str, arch: str, path: str, tokens: int,
                 dev: str = "cuda"):
    """One model of phase 14 or 15 (``--quick``: its smoke config) as
    published with random weights: a prefill of FAMILY_BATCH prompts (with
    the family's frames or patches), one decode step (the encdec's with
    the encoder's output), the batcher's 12 requests (the encdec's without
    cross-attention, as the reference's batcher runs it), a float32 copy
    against float64, every K6 call recorded. Returns (K6 rows {path:
    row}, (cfg, the model's first HYBRID_CUT layers for zamba2's train
    check, else None))."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.rmsnorm import _fwd_layout
    from repro_torch.models import transformer as TT
    from repro_torch.serving.scheduler import ContinuousBatcher, Request

    t_cell = time.perf_counter()
    reset_peak()
    cfg = get_smoke_config(arch) if args.quick else get_config(arch)
    params = TT.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{path}: {cfg.name} ({cfg.family}, {cfg.dtype}, {cfg.n_layers} "
        f"layers" + (f" + {cfg.n_enc_layers} encoder" if cfg.n_enc_layers
                     else "")
        + f", d_model {cfg.d_model}, heads {cfg.n_heads} / {cfg.n_kv_heads}"
        + (f", Mamba{cfg.ssm_version} d_inner {cfg.d_inner} state "
           f"{cfg.ssm_state}" + (f" heads {cfg.ssm_heads}"
                                 if cfg.ssm_version == 2 else "")
           + f" conv {cfg.ssm_conv} chunk {cfg.ssm_chunk}" if cfg.is_ssm
           else "")
        + (f", shared attention every {cfg.attn_every}"
           if cfg.family == "hybrid" else "")
        + (f", frontend {cfg.frontend} x {cfg.frontend_len}"
           if cfg.frontend else "")
        + f", vocab {cfg.vocab_size}): {n_params:,} parameters "
        f"({n_params * 2 / 1e9:.2f} GB), random (torch.Generator({dev!r}) "
        f"seed 0), init {time.perf_counter() - t_cell:.1f} s")
    rng = np.random.default_rng(0)
    B = FAMILY_BATCH
    S = min(tokens, 16) if args.quick else tokens
    batch = _family_inputs(cfg, B, S, rng, dev)
    encdec = cfg.family == "encdec"
    P_ = 0 if encdec or cfg.frontend is None else cfg.frontend_len
    first = batch["tokens"][:, :1]
    max_len = LM_SERVE["max_len"]
    rows_d = [B * (P_ + S), B] + ([B * cfg.frontend_len] if encdec else [])
    for rows in rows_d:
        log(f"K6 at [{rows}, {cfg.d_model}] {cfg.dtype}: "
            f"{k6_launch_lanes(rows, cfg.d_model, 2)} lanes a row "
            f"(_fwd_layout: {_fwd_layout(cfg.d_model, 2)}), "
            f"{-(-cfg.d_model // 8)} 16-byte chunks a row")
    per_pre = k6_per_step(cfg, cross=encdec, encoder=encdec)
    per_dec = k6_per_step(cfg, cross=encdec)
    per_serve = k6_per_step(cfg)

    # the counted runs, their kernel calls recorded as they launch (the
    # prefill's to host memory: llava's 65 calls hold 4.4 GB)
    out = {}
    with torch.no_grad():
        ops.reset_launch_counts()
        with flash_watch() as flash:
            pre_calls = record_kernel_calls(lambda: out.update(
                logits=TT.forward(params, cfg, None, batch)), host=True)
        pre_launches = ops.launch_counts()
        check_finite(out.pop("logits"), (B, P_ + S, cfg.vocab_size),
                     f"{path} prefill logits")
        enc_out = TT._encode(params, cfg, None, batch["enc_embeds"]) \
            if encdec else None
        cache = TT.init_decode_cache(cfg, B, max_len, device=dev)
        ops.reset_launch_counts()
        dec_calls = record_kernel_calls(lambda: out.update(
            step=TT.decode_step(params, cfg, None, first, cache, enc_out)))
        dec_launches = ops.launch_counts()
        step_logits, cache = out.pop("step")
        check_finite(step_logits, (B, 1, cfg.vocab_size), f"{path} decode")
        written = cache.ssm_h[:, :, 0] if cfg.family == "ssm" else (
            cache.shared_k if cfg.family == "hybrid" else cache.k)[:, :, :, 0]
        if not bool(written.abs().sum() > 0) or (
                cfg.is_ssm and not bool(cache.ssm_h.abs().sum() > 0)):
            raise AssertionError(f"{path} decode: the cache was not written")
    log(f"{path} prefill {B}x" + (f"({P_}+{S})" if P_ else f"{S}")
        + (f" over {cfg.frontend_len} encoder frames" if encdec else "")
        + f" launches: {json.dumps(pre_launches)}; one decode step (B={B}"
        + (", enc_out" if encdec else "") + f"): {json.dumps(dec_launches)}"
        f"; flash_attention calls (causal, device, q shape): "
        f"{dict((str(k), n) for k, n in flash.calls.items())}")
    for what, n, want in ((f"{path} prefill", pre_launches, per_pre),
                          (f"{path} decode step", dec_launches, per_dec)):
        if n["rmsnorm"] != want or sum(n.values()) != want:
            raise AssertionError(f"{what}: K6 launched {n['rmsnorm']} times "
                                 f"(want {want}) or another kernel ran: {n}")
    # the flash path at 1024 positions: the encoder's (non-causal) and the
    # prefix model's (causal), on the card
    want_flash = {}
    if not args.quick and encdec:
        want_flash = {(False, "cuda"): cfg.n_enc_layers}
    elif not args.quick and P_:
        want_flash = {(True, "cuda"): cfg.n_layers}
    got_flash = collections.Counter()
    for (causal, kind, _), n in flash.calls.items():
        got_flash[(causal, kind)] += n
    if dict(got_flash) != want_flash:
        raise AssertionError(f"{path} prefill: flash_attention calls "
                             f"{dict(got_flash)}, want {want_flash}")
    del step_logits

    # the batcher: LM_SERVE's 12 requests through 8 slots (no enc_out: the
    # reference's batcher decodes an encdec model without cross-attention)
    reqs = lm_requests(Request, cfg.vocab_size)
    batcher = ContinuousBatcher(cfg, params, LM_SERVE["max_batch"], max_len)
    for r in reqs:
        batcher.submit(r)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    stats = batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_launches = ops.launch_counts()
    want_tokens = LM_SERVE["requests"] * LM_SERVE["new_tokens"]
    if stats.served != LM_SERVE["requests"] or \
            stats.generated_tokens != want_tokens or \
            serve_launches["rmsnorm"] != per_serve * stats.decode_steps:
        raise AssertionError(f"{path} batcher: served {stats.served}, "
                             f"{stats.generated_tokens} tokens, launches "
                             f"{serve_launches} over {stats.decode_steps} "
                             f"steps")
    log(f"{path} batcher [{card}]: served {stats.served}, generated "
        f"{stats.generated_tokens} tokens in {stats.decode_steps} decode "
        f"steps ({want_tokens / wall:.1f} tokens/s, host wall {wall:.3f} s),"
        f" launches {json.dumps(serve_launches)}")
    again = lm_requests(Request, cfg.vocab_size)[:LM_SERVE["max_batch"]]
    b2 = ContinuousBatcher(cfg, params, LM_SERVE["max_batch"], max_len)
    for r in again:
        b2.submit(r)
    serve_calls = record_kernel_calls(b2.run)
    if [r.output for r in again] != [r.output for r in
                                     reqs[:LM_SERVE["max_batch"]]]:
        raise AssertionError(f"{path} batcher: a second run of the first "
                             f"wave gave other tokens")
    serve_calls = {k: v[-8 * per_serve:] for k, v in serve_calls.items()}

    with torch.no_grad():
        for fn, what, tok in (
                (lambda: TT.forward(params, cfg, None, batch),
                 f"{path} prefill {B}x{P_ + S}", B * (P_ + S)),
                (lambda: TT.decode_step(params, cfg, None, first, cache,
                                        enc_out),
                 f"{path} decode step B={B}", B)):
            prefill = what.startswith(f"{path} prefill")
            reps = FAMILY_PREFILL_REPS if prefill else 7
            if prefill and path in DRYRUN_PREFILLS:
                # phase 16's cell: the timed prefills' peak beside them
                placed = tensor_bytes(params, batch)

                def timed(fn=fn):
                    dev_ms, host_ms = median_ms(fn, reps)
                    return ((dev_ms, host_ms), dev_ms,
                            f"median of {reps} by CUDA events", placed)

                dev_ms, host_ms = measure_step(f"{path}_prefill", cfg,
                                               P_ + S, B, "prefill", timed,
                                               placed)
            else:
                dev_ms, host_ms = median_ms(fn, reps)
            log(f"{what} [{card}]: median of {reps}: {dev_ms:.3f} ms device "
                f"events, {host_ms:.3f} ms host wall "
                f"({tok / host_ms * 1e3:.1f} tokens/s)")
    log(f"peak device memory, {path} (weights, prefill, batcher): "
        f"{peak_allocated() / 2 ** 30:.2f} GiB")
    del cache, batcher, b2, enc_out

    # a float32 copy of the first layers against float64 (the plain
    # versions); decode == forward where the family's decode sees every
    # position (the prefix never enters the cache)
    n_l = min(HYBRID_CUT if cfg.family == "hybrid" else LM_F32["n_layers"],
              cfg.n_layers)
    n_e = min(LM_F32["n_layers"], cfg.n_enc_layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=n_l,
                                n_enc_layers=n_e)
    cut = None
    if cfg.family == "hybrid":  # the train check's weights, cloned
        cut = TT._tree_map(lambda t: t.clone(), _cut(params, cfg, n_l))
    p32 = TT._tree_map(lambda t: t.float(), _cut(params, cfg, n_l, n_e))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # llava: 448 tokens after the patches, so the copy's attention takes
    # flash (causal) as the prefill did
    n_tok = S if P_ else LM_F32["tokens"]
    b32 = _family_inputs(cfg32, LM_F32["batch"], n_tok, rng, dev)
    with torch.no_grad():
        fwd32 = TT.forward(p32, cfg32, None, b32)
        check_finite(fwd32, (LM_F32["batch"], P_ + n_tok, cfg.vocab_size),
                     f"{path} float32")
        dec_note = ""
        if not P_:
            enc32 = TT._encode(p32, cfg32, None, b32["enc_embeds"]) \
                if encdec else None
            cache32 = TT.init_decode_cache(cfg32, LM_F32["batch"], n_tok,
                                           device=dev)
            steps = []
            for j in range(n_tok):
                out, cache32 = TT.decode_step(
                    p32, cfg32, None, b32["tokens"][:, j:j + 1], cache32,
                    enc32)
                steps.append(out)
            dec_note = check_close(torch.cat(steps, dim=1), _host64(fwd32),
                                   f"{path} decode vs forward")
            del cache32, steps, enc32
        cfg64 = dataclasses.replace(cfg32, dtype="float64")
        p64 = TT._tree_map(lambda t: t.double(), p32)
        with plain_kernels(), flash_watch() as flash64:
            fwd64 = TT.forward(p64, cfg64, None, b32)
    log(f"{path} float32 copy ({n_l} layers" + (f" + {n_e} encoder"
                                                if n_e else "")
        + f", {LM_F32['batch']}x" + (f"({P_}+{n_tok})" if P_ else f"{n_tok}")
        + " tokens" + (f" over {cfg.frontend_len} frames" if encdec else "")
        + f"; flash calls in the float64 run "
        f"{dict((str(k), n) for k, n in flash64.calls.items())}): "
        + (f"decode_step" + (" (enc_out from _encode)" if encdec else "")
           + f" vs forward: {dec_note}; " if dec_note else "")
        + f"forward vs the float64 plain run: "
        f"{check_close(fwd32, _host64(fwd64), f'{path} forward vs float64')}")
    del p32, p64, fwd64, fwd32
    gc.collect()
    torch.cuda.empty_cache()

    rows = {f"{path}_prefill": kernel_row("rmsnorm", pre_calls["rmsnorm"],
                                          pre_launches["rmsnorm"]),
            f"{path}_step": kernel_row("rmsnorm", dec_calls["rmsnorm"],
                                       dec_launches["rmsnorm"]),
            f"{path}_batcher": kernel_row("rmsnorm", serve_calls["rmsnorm"],
                                          serve_launches["rmsnorm"])}
    del pre_calls, dec_calls, serve_calls
    log(f"{path} cell ({cfg.name}): {time.perf_counter() - t_cell:.1f} s")
    return rows, (cfg, cut)


def hybrid_train(args, card: str, cfg, params, dev: str = "cuda") -> dict:
    """zamba2's first HYBRID_CUT layers at full width in bf16 (remat): one
    step's K1 / K2 / K6 / K6-backward calls recorded, every leaf's
    gradient finite and non-zero (the shared block's sums its two uses),
    FAMILY_TRAIN's steps through ``make_train_step`` counted from 0 (the
    loss falling), each step timed; a float32 copy's first-step grads
    held to float64 leaf by leaf norm-wise, ||g32 - g64|| <= 2e-3
    ||g64|| (FAMILY_TRAIN_F32), with each leaf's element-wise error over
    rtol 2e-3 / atol 2e-4 logged, and the bf16 model's norm-wise errors
    on the same tokens logged beside them (the control). Returns {kernel:
    {path: row}} of the hybrid_train path."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as TT
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.steps import loss_and_grads, make_train_step

    t0 = time.perf_counter()
    reset_peak()
    cfg = dataclasses.replace(cfg, n_layers=HYBRID_CUT if not args.quick
                              else cfg.n_layers)
    n_params = sum(t.numel() for t in _leaves(params))
    seq = 16 if args.quick else FAMILY_TRAIN["seq"]
    toks = SyntheticLM(cfg.vocab_size, seq, FAMILY_TRAIN["batch"],
                       seed=0).batch(0)["tokens"]
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    _, grads = loss_and_grads(params, cfg, None, batch)
    check_all_grads(grads, "hybrid-train")
    del grads
    calls = recorded_grads(cfg, None, params, batch)
    opt = AdamWConfig(**FAMILY_TRAIN_OPT)
    step = make_train_step(cfg, None, opt)
    p, state, losses, times = params, adamw_init(params), [], []
    ev = _events(2)
    ops.reset_launch_counts()
    for _ in range(FAMILY_TRAIN["steps"]):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ev[0].record()
        p, state, m = step(p, state, batch)
        ev[1].record()
        torch.cuda.synchronize()
        times.append((ev[0].elapsed_time(ev[1]),
                      (time.perf_counter() - t1) * 1e3))
        losses.append(float(m["loss"]))
    launches = ops.launch_counts()
    groups = cfg.n_layers // cfg.attn_every
    per_step = k6_per_step(cfg)
    want = ("gather_rows", "scatter_add_rows", "rmsnorm", "rmsnorm_bwd")
    if min(launches[k] for k in want) < 1 or \
            launches["rmsnorm_bwd"] != FAMILY_TRAIN["steps"] * per_step:
        raise AssertionError(f"hybrid-train: launches {launches} (K6's "
                             f"backward: want {FAMILY_TRAIN['steps']} x "
                             f"{per_step})")
    if not losses[-1] < losses[0] or not all(np.isfinite(losses)):
        raise AssertionError(f"hybrid-train: the loss did not fall: {losses}")
    log(f"hybrid-train [{card}]: {cfg.name}'s first {cfg.n_layers} layers "
        f"({groups} groups, the shared block applied {groups} times; remat "
        f"{cfg.remat}), {n_params:,} parameters, {FAMILY_TRAIN['batch']}x"
        f"{seq} SyntheticLM (seed 0); {FAMILY_TRAIN['steps']} steps' launches"
        f" {json.dumps(launches)}; losses {[round(x, 4) for x in losses]}; "
        f"a step (CUDA events / host wall) "
        f"{[(round(a, 3), round(b, 3)) for a, b in times]} ms; "
        f"{toks.size / times[-1][1] * 1e3:.1f} tokens/s (last step); every "
        f"leaf's gradient finite and non-zero; peak device memory "
        f"{peak_allocated() / 2 ** 30:.2f} GiB")
    del p, state

    # float32 copy vs float64 (the plain versions): the first step's grads
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = TT._tree_map(lambda t: t.float(), params)
    seq32 = 16 if args.quick else FAMILY_TRAIN_F32["seq"]
    t32 = SyntheticLM(cfg.vocab_size, seq32, FAMILY_TRAIN_F32["batch"],
                      seed=0).batch(0)["tokens"]
    b32 = {"tokens": torch.from_numpy(t32).to(dev)}
    loss32, g32 = loss_and_grads(p32, cfg32, None, b32)
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    p64 = TT._tree_map(lambda t: t.double(), p32)
    with plain_kernels():
        loss64, g64 = loss_and_grads(p64, cfg64, None, b32)
    del p64
    # the control: the bf16 model's grads on the same tokens, which the
    # norm-wise limit must tell from float32's
    _, g16 = loss_and_grads(params, cfg, None, b32)
    rel16 = sorted(r[0] for r in grad_rel_errors(g16, g64))
    del g16
    rel = grad_rel_errors(g32, g64)
    bad = [r for r in rel if not r[0] <= GRAD_TOL["rtol"]]
    shared = [r for r in rel if r[1].startswith("shared_attn/")]
    log(f"  hybrid float32 copy ({cfg.n_layers} layers, {t32.shape[0]}x"
        f"{t32.shape[1]}): loss {float(loss32):.6f} vs float64 "
        f"{float(loss64):.6f}; first-step grads, each leaf's "
        f"||g32 - g64|| / ||g64|| (<= {GRAD_TOL['rtol']} passes) and its "
        f"element-wise error over rtol 2e-3 / atol 2e-4 (logged): worst "
        f"{[(f'{a:.3g}', n, f'{o:.3g}') for a, n, o in rel[:4]]}; "
        f"shared_attn worst {shared[0][0]:.3g} (element-wise "
        f"{max(o for _, _, o in shared):.3g}); the bf16 control's "
        f"||g16 - g64|| / ||g64||: least {rel16[0]:.3g}, most "
        f"{rel16[-1]:.3g}, {sum(r > GRAD_TOL['rtol'] for r in rel16)} of "
        f"{len(rel16)} leaves over {GRAD_TOL['rtol']}; hybrid-train "
        f"{time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError(f"hybrid float32 grads vs float64: {bad}")
    del g32, g64, p32
    gc.collect()
    torch.cuda.empty_cache()
    return {k: {"hybrid_train": kernel_row(k, calls[k], launches[k])}
            for k in want}


def family_phase(args, card: str, dev: str = "cuda") -> dict:
    """Phase 15: zamba2-2.7b, seamless-m4t-medium and llava-next-mistral-7b
    served one after another (each model's weights freed before the next
    is built), then zamba2's 12-layer train check. Returns {kernel:
    {path: row}}."""
    t_phase = time.perf_counter()
    rows = {"rmsnorm": {}}
    train = None
    for arch, path, tokens in FAMILY_CELLS:
        got, (cfg, cut) = family_serve(args, card, arch, path, tokens, dev)
        rows["rmsnorm"].update(got)
        if cut is not None:
            train = (cfg, cut)
        gc.collect()
        torch.cuda.empty_cache()
    for k, per_path in hybrid_train(args, card, *train, dev=dev).items():
        rows.setdefault(k, {}).update(per_path)
    for k in ("rmsnorm", "rmsnorm_bwd"):
        for path, r in rows[k].items():
            lib = (f"F.rms_norm "
                   f"{r['library_busy_ms'] / r['kernel_busy_calls']:.5f}"
                   if "library_busy_ms" in r else
                   f"library (F.rms_norm autograd backward) by events "
                   f"{r['library_ms'] / r['calls_per_h']:.5f}")
            log(f"K6 {'backward' if k.endswith('bwd') else 'forward'} on "
                f"{path} [{card}]: busy "
                f"{r['kernel_busy_ms'] / r['kernel_busy_calls']:.5f} ms a "
                f"call {json.dumps(r['kernel_busy_ms_by_kernel'])}, {lib}, "
                f"bound {r['bound_ms'] / r['calls_per_h']:.5f} ms a call "
                f"({r['bound_by']}), {r['launches']} launches")
    log(f"phase 15 hybrid / encdec / prefix families: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 16: the dry run (launch/dryrun.py) against the card
# ---------------------------------------------------------------------------

# phase 16's cells, in the order they print: MEASURED's keys
DRYRUN_CELLS = ("olmoe_train", "smollm_train", "hybrid_prefill",
                "encdec_prefill", "vlm_prefill")
# run_cell unchanged on the production (16, 16) grid, with probes: a
# dense cell and one whose expert-parallel exchange the trace logs
DRYRUN_GRID_CELLS = (("qwen2-1.5b", "decode_32k"),
                     ("olmoe-1b-7b", "decode_32k"))
# (arguments + temp) / the measured peak of the donating train steps
DRYRUN_TRAIN_HOLD = (0.95, 1.05)


def dryrun_phase(args, card: str) -> None:
    """Phase 16: ``launch/dryrun.py``'s accounting of each step phases 13
    and 15 measured (``MEASURED``), traced on the meta device in this
    process on a (data 1, model 1) grid at the shape the phase ran, full
    depth: its argument bytes equal to the bytes of the tensors the phase
    placed on the card (any difference fails); arguments + temp (and +
    outputs, logged) beside the peak the step requested above its start
    with its arguments — the train steps donate their parameters and
    moments (the dry run traces the donating step), so their peak is
    arguments + temp, held within ``DRYRUN_TRAIN_HOLD``; the traced flops
    over the measured time as TFLOP/s; the roofline's bound (H100
    datasheet constants) over the measured time. Then ``run_cell`` as
    the CLI runs it for ``DRYRUN_GRID_CELLS``, records and seconds
    printed."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as TD
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    launches = ops.launch_counts()
    missing = [c for c in DRYRUN_CELLS if c not in MEASURED]
    if missing:
        raise AssertionError(f"phase 16: no measured step for {missing}")
    grid = make_mesh((1, 1), ("data", "model"))
    for cell in DRYRUN_CELLS:
        m = MEASURED[cell]
        cfg, shape = m["cfg"], m["shape"]
        t0 = time.perf_counter()
        rec = TD.account(cfg, shape, grid, probes=False)
        mem, cost, roof = rec["memory"], rec["cost"], rec["roofline"]
        args_b = mem["argument_size_in_bytes"]
        if args_b != m["placed"]:
            raise AssertionError(
                f"phase 16 {cell}: the dry run's argument bytes {args_b:,.0f}"
                f" != the {m['placed']:,} bytes the phase placed on the card")
        temp = mem["temp_size_in_bytes"]
        out_b = mem["output_size_in_bytes"]
        hold = (args_b + temp) / m["peak"]
        if shape.mode == "train" and not (
                DRYRUN_TRAIN_HOLD[0] <= hold <= DRYRUN_TRAIN_HOLD[1]):
            raise AssertionError(
                f"phase 16 {cell}: arguments + temp {args_b + temp:,.0f} "
                f"is {hold:.3f} of the donating step's peak {m['peak']:,}, "
                f"outside {DRYRUN_TRAIN_HOLD}")
        secs = m["ms"] / 1e3
        log(f"dry run vs card, {cell} ({cfg.name}, {cfg.n_layers} layers, "
            f"{shape.mode} {shape.global_batch} x {shape.seq_len}) [{card}]:"
            f" argument bytes {args_b:,.0f} == placed {m['placed']:,}; "
            f"arguments + temp {(args_b + temp) / 2 ** 30:.3f} GiB, + "
            f"outputs {(args_b + temp + out_b) / 2 ** 30:.3f} GiB vs the "
            f"step's peak {m['peak'] / 2 ** 30:.3f} GiB (ratio "
            f"{(args_b + temp) / m['peak']:.3f} / "
            f"{(args_b + temp + out_b) / m['peak']:.3f}); traced flops "
            f"{cost['flops']:.6g} over the measured {m['ms']:.3f} ms "
            f"({m['how']}): {cost['flops'] / secs / 1e12:.2f} TFLOP/s; "
            f"bytes accessed {cost['bytes accessed']:.6g}; bound "
            f"{roof['bound_time'] * 1e3:.3f} ms ({roof['bottleneck']}; "
            f"compute {roof['compute'] * 1e3:.3f}, memory "
            f"{roof['memory'] * 1e3:.3f} ms), bound / measured "
            f"{roof['bound_time'] / secs:.3f}; kernels reached (meta "
            f"calls) {json.dumps(rec['kernel_calls'])}; traced in "
            f"{time.perf_counter() - t0:.1f} s")
    traced = {}
    for arch, shape_name in DRYRUN_GRID_CELLS:
        t0 = time.perf_counter()
        rec = TD.run_cell(arch, shape_name)
        if rec["status"] != "run":
            raise AssertionError(f"phase 16 {arch} {shape_name}: {rec}")
        traced[arch] = rec["collectives"]["traced"]["total"]
        log(f"dry run {arch} x {shape_name} on the (16, 16) grid "
            f"({time.perf_counter() - t0:.1f} s; meta-device trace, "
            f"datasheet constants, not measured): {json.dumps(rec)}")
    if not traced["olmoe-1b-7b"] > 0:
        raise AssertionError(f"phase 16: the EP cell traced no collective: "
                             f"{traced}")
    if ops.launch_counts() != launches:
        raise AssertionError("phase 16: a meta trace moved the kernels' "
                             "launch counts")
    log(f"phase 16 dry run: {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="small matrix and olmoe-smoke; skips the "
                             "full-size decision checks")
    parser.add_argument("--profile", action="store_true",
                        help="also print a torch.profiler breakdown of one "
                             "h(b) per cell, one GAT forward per backend, "
                             "one training step per training cell, one LM "
                             "prefill and one decode step")
    parser.add_argument("--mp-worker", metavar="DIR",
                        help="run as one worker of phase 11 (b), writing "
                             "its results under DIR (the phase starts it)")
    parser.add_argument("--mp-train-worker", metavar="DIR",
                        help="run as one worker of phase 12, writing its "
                             "results under DIR (the phase starts it)")
    parser.add_argument("--mp-ragged-worker", metavar="DIR",
                        help="run as one worker of phase 12's ragged grid, "
                             "writing its results under DIR (the phase "
                             "starts it)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if args.mp_worker:
        mp_worker(args)
        return 0
    if args.mp_train_worker:
        mp_train_worker(args)
        return 0
    if args.mp_ragged_worker:
        mp_ragged_worker(args)
        return 0
    from repro_torch import SpmmConfig, compile_fused, compile_spmm
    from repro_torch.core.dist_spmm import flat_spmm
    from repro_torch.core.sparse import power_law_sparse, random_sparse
    from repro_torch.kernels import build, ops
    from repro_torch.models.gnn import (
        gat_forward, gat_from_numpy, normalize_adjacency,
    )

    t_start = time.perf_counter()
    marks = [t_start]

    def mark(done: str) -> None:
        """Log the elapsed seconds and those of the phase just done."""
        now = time.perf_counter()
        log(f"elapsed {now - t_start:.1f} s; {done}: {now - marks[-1]:.1f} s;"
            f" host RSS {host_rss_gb():.1f} GB")
        marks.append(now)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"toolchain: {toolchain()}")

    # 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    log(f"build: K1-K6 in {time.perf_counter() - t0:.1f} s -> "
        f"{build.build()}")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    m = 16_384 if args.quick else M_FULL
    nnz = 7 * m if args.quick else NNZ_FULL
    rng = np.random.default_rng(0)
    b_host = rng.standard_normal((m, N_COLS), dtype=np.float32)
    b = torch.from_numpy(b_host).cuda()

    mark("phase 1 (build)")
    # 2. uniform cell: plan, then record + replay the kernels ------------
    t0 = time.perf_counter()
    a_u = random_sparse(m, m, nnz / m ** 2, seed=0)
    cfg = SpmmConfig(backends=("coo", "bsr"))
    if args.quick:
        cfg = SpmmConfig(backends=("coo", "bsr"), schedule=2, overlap=True)
    h = compile_spmm(a_u, P, cfg)
    log(f"uniform: {m}x{m}, nnz {a_u.nnz}, compile_spmm "
        f"{time.perf_counter() - t0:.1f} s: {h}")
    if not args.quick:
        check_decisions(h, EXPECT_UNIFORM, EXPECT_UNIFORM_EX, "uniform")
    for piece in ("diag", "rowp"):
        log(f"  bsr {piece} ELL: "
            f"{list(h.ex.pieces['bsr'][piece]['blocks'].shape)}")

    # the executor calls h(b, backend="bsr") and h(b) make, outside the
    # handle's cache and before the counted run
    calls = record_kernel_calls(
        lambda: flat_spmm(h.ex, b, backend="bsr", overlap=h.overlap))
    coo_calls = record_kernel_calls(
        lambda: flat_spmm(h.ex, b, backend="coo", overlap=h.overlap))
    sweep_checks()

    # 3. main path, uniform: counts from 0 over exactly these calls -------
    ops.reset_launch_counts()
    c_coo = h(b)
    check_rows(h, "uniform coo")
    c_bsr = h(b, backend="bsr")
    check_rows(h, "uniform bsr")
    c_hit = h(b)
    check_rows(h, "uniform coo (cache hit)")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"uniform main path launches: {json.dumps(launches)}")
    if min(launches[k] for k in KERNELS
           if k not in ("bsr_sddmm", "rmsnorm", "rmsnorm_bwd")) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if h.cache_info()["lowerings"] != 2 or h.cache_info()["hits"] != 1:
        raise AssertionError(f"cache: {h.cache_info()}")
    for c, what in [(c_coo, "uniform coo"), (c_bsr, "uniform bsr"),
                    (c_hit, "uniform coo (cache hit)")]:
        log(f"  {what}: max abs err vs scipy float64 "
            f"{check_c(c, a_u, b_host, what):.3g} (tol 2e-4)")
    for backend, c in (("bsr", c_bsr), ("coo", c_coo)):
        c_staged = flat_spmm(h.ex, b, backend=backend, overlap=False)
        if not torch.equal(c_staged, c):
            raise AssertionError(f"uniform {backend}: staged C != "
                                 f"overlapped C")
        log(f"  uniform {backend}: staged C bit-identical to overlapped C")
    if not torch.equal(c_hit, c_coo):
        raise AssertionError("uniform coo: two h(b) calls differ")
    log("  uniform coo: two h(b) calls bit-identical")

    # 4. power-law cell, coo ---------------------------------------------
    t0 = time.perf_counter()
    a_p = power_law_sparse(m, m, nnz, 0.8, seed=0)
    hp = compile_spmm(a_p, P, SpmmConfig(backends=("coo",)))
    log(f"power-law: {m}x{m}, nnz {a_p.nnz}, compile_spmm "
        f"{time.perf_counter() - t0:.1f} s: {hp}")
    if not args.quick:
        check_decisions(hp, EXPECT_POWERLAW, {}, "power-law")
    # the executor call hp(b) makes (K1/K2 at this cell's own shapes),
    # outside the handle's cache and before the counted run
    p_calls = record_kernel_calls(
        lambda: flat_spmm(hp.ex, b, backend="coo", overlap=hp.overlap))
    ops.reset_launch_counts()
    c_p = hp(b)
    check_rows(hp, "power-law coo")
    c_p2 = hp(b)
    torch.cuda.synchronize()
    p_launches = ops.launch_counts()
    log(f"power-law main path launches: {json.dumps(p_launches)}")
    if min(p_launches[k] for k in ("gather_rows", "gather_rows_scaled",
                                   "scatter_add_rows")) < 1:
        raise AssertionError(f"power-law: K1/K2 not launched: {p_launches}")
    for c, what in [(c_p, "power-law coo"), (c_p2, "power-law coo (hit)")]:
        log(f"  {what}: max abs err vs scipy float64 "
            f"{check_c(c, a_p, b_host, what):.3g} (tol 2e-4)")
    if hp.overlap:
        c_staged = flat_spmm(hp.ex, b, backend="coo", overlap=False)
        if not torch.equal(c_staged, c_p):
            raise AssertionError("power-law coo: staged C != overlapped C")
        log("  power-law coo: staged C bit-identical to overlapped C")
    if not torch.equal(c_p2, c_p):
        raise AssertionError("power-law coo: two h(b) calls differ")
    log("  power-law coo: two h(b) calls bit-identical")

    # 5. GAT on the fused handle (uniform graph) ----------------------------
    t0 = time.perf_counter()
    adj = normalize_adjacency(a_u)
    hf = compile_fused(adj, P, SpmmConfig(
        kernel="fused", edge="leaky_relu", backends=("coo", "bsr")))
    gat_prep_s = time.perf_counter() - t0
    log(f"GAT graph: normalize_adjacency(uniform), nnz {adj.nnz}, "
        f"compile_fused {gat_prep_s:.1f} s: {hf}")
    if not args.quick:
        check_decisions(hf, EXPECT_FUSED, {}, "fused")
    params = gat_params(0)
    # inference only: phase 5d trains its own copy
    model = gat_from_numpy(params, m, device="cuda").requires_grad_(False)
    feats_host = rng.standard_normal((m, GAT_DIMS["feat_dim"]),
                                     dtype=np.float32)
    feats = torch.from_numpy(feats_host).cuda()
    want = gat_oracle(adj, params, feats_host)
    fused_fn, gat_rec, gat_launches, gat_out = gat_cell(
        hf, model, feats, adj, b, want, "GAT")
    gat_calls, gat_calls_coo = gat_rec["bsr"], gat_rec["coo"]

    # SDDMM at a 128-wide F on bsr
    x128 = torch.randn((m, SDDMM_F), device="cuda")
    y128 = torch.randn((m, SDDMM_F), device="cuda")
    sd_calls, sd_launches, vals = sddmm_cell(hf, adj, x128, y128, "sddmm")

    # every recorded call of each path replayed against the plain version
    # and timed; a row's top level is its first path's, "paths" holds
    # each path's own numbers and max_abs_err is the worst over them. The
    # recorded arguments are dropped once replayed, before phase 5b
    # records its own.
    k1k2 = {"uniform": (calls, launches), "uniform_coo": (coo_calls, launches),
            "power_law": (p_calls, p_launches),
            "gat": (gat_calls, gat_launches["bsr"]),
            "gat_coo": (gat_calls_coo, gat_launches["coo"])}
    coo_paths = {k: k1k2[k] for k in ("uniform_coo", "power_law", "gat_coo")}
    paths = {
        "gather_rows": {**k1k2, "sddmm_f128": (sd_calls, sd_launches)},
        "gather_rows_scaled": coo_paths,
        "scatter_add_rows": k1k2,
        "bsr_spmm": {"uniform": (calls, launches),
                     "gat": (gat_calls, gat_launches["bsr"])},
        "bsr_spmm_acc": {"uniform": (calls, launches)},
        "bsr_sddmm": {"gat": (gat_calls, gat_launches["bsr"]),
                      "sddmm_f128": (sd_calls, sd_launches)},
    }
    per_kernel = replay_paths(paths)
    del (calls, coo_calls, p_calls, gat_calls, gat_calls_coo, gat_rec,
         sd_calls, paths, k1k2, coo_paths)
    gc.collect()

    mark("phases 2-5 (kernels, SpMM cells, GAT)")
    # 5b. the hierarchical tier: hier="auto" on the same matrices ---------
    hier_rows, hu, hph, hgf, hier_fused_fn = hier_phase(
        args, a_u, a_p, adj, b, b_host, model, feats, want, x128, y128)
    for k, extra in hier_rows.items():
        per_kernel[k].update(extra)

    mark("phase 5b")
    # 5c. the replicated tier: replicate="auto" on the SpMM matrices ------
    repl_rows, (hru, hrp) = repl_phase(args, a_u, a_p, b, b_host)
    for k, extra in repl_rows.items():
        per_kernel[k].update(extra)
    del repl_rows
    gc.collect()

    mark("phase 5c")
    # 5d. training: grads through every SpMM handle, GCN and GAT cells --
    # (each training cell resets the peak to report its own)
    peak_before_5d = peak_allocated()
    train_rows, _ = train_phase(
        args, card, a_p, adj,
        [(h, a_u, "uniform"), (hp, a_p, "power-law"),
         (hu, a_u, "hier uniform"), (hph, a_p, "hier power-law"),
         (hru, a_u, "repl uniform"), (hrp, a_p, "repl power-law")],
        hf, gat_prep_s, b, b_host, params)
    for k, extra in train_rows.items():
        per_kernel[k].update(extra)
    del train_rows
    gc.collect()

    mark("phase 5d")
    # 6. timing --------------------------------------------------------
    # each hier and replicated cell beside the flat handle on the same
    # matrix, in turns
    cells = [(h, "coo", "uniform coo"), (hu, "coo", "hier uniform coo"),
             (hru, "coo", "repl uniform coo"),
             (h, "bsr", "uniform bsr"), (hu, "bsr", "hier uniform bsr"),
             (hru, "bsr", "repl uniform bsr"),
             (hp, "coo", "power-law coo"),
             (hph, "coo", "hier power-law coo"),
             (hrp, "coo", "repl power-law coo")]
    for handle, backend, what in cells:
        dev_ms, host_ms = median_ms(
            lambda: handle(b, backend=backend))
        log(f"h(b) {what} [{card}]: median of 7: {dev_ms:.3f} ms device "
            f"events, {host_ms:.3f} ms host wall")
    gat_cells = [(fn, be, what) for be in ("coo", "bsr")
                 for fn, what in ((fused_fn, "GAT forward"),
                                  (hier_fused_fn, "hier GAT forward"))]
    for fn, backend, what in gat_cells:
        dev_ms, host_ms = median_ms(
            lambda: gat_forward(model, feats, fn(backend)))
        log(f"{what} {backend} [{card}]: median of 7: {dev_ms:.3f} ms "
            f"device events, {host_ms:.3f} ms host wall")
    if args.profile:
        seen = profile_cells(
            [(lambda hh=hh, be=be: hh(b, backend=be), what)
             for hh, be, what in cells]
            + [(lambda fn=fn, be=be: gat_forward(model, feats, fn(be)),
                f"{what} {be}") for fn, be, what in gat_cells])
        # the coo multiply rides in K1's scaled form: no kernel of its own
        # (a MulFunctor<bool> is torch.isfinite in the front door's
        # sampled C sweep, not a product)
        muls = [k for k in seen["power-law coo"]
                if "MulFunctor" in k and "MulFunctor<bool>" not in k]
        if muls:
            raise AssertionError(f"power-law coo ran a multiply kernel: "
                                 f"{muls}")
        log("profile power-law coo: no separate multiply kernel")
    log(f"peak device memory, phases 1-6: "
        f"{max(peak_before_5d, peak_allocated()) / 2 ** 30:.2f}"
        f" GiB")

    mark("phase 6")
    # 7. LM serving, after the SpMM phases' tensors are released ---------
    del (h, hp, hf, model, feats, b, gat_out, vals, x128, y128, c_coo,
         c_bsr, c_hit, c_p, c_p2, hu, hph, hgf, hier_fused_fn, cells,
         gat_cells, fused_fn, hru, hrp)
    gc.collect()
    torch.cuda.empty_cache()
    reset_peak()
    lm_paths, lm_cfg, lm_params = lm_serving(args, card)
    for k, extra in lm_paths.items():
        per_kernel.setdefault(k, {}).update(extra)
    log(f"peak device memory, phase 7: "
        f"{peak_allocated() / 2 ** 30:.2f} GiB")

    mark("phase 7")
    # 10. the expert-parallel LM on an emulated (data 2, model 4) grid,
    #     on phase 7's weights
    reset_peak()
    for k, extra in ep_phase(args, card, lm_cfg, lm_params).items():
        per_kernel[k].update(extra)
    log(f"peak device memory, phase 10: "
        f"{peak_allocated() / 2 ** 30:.2f} GiB")
    del lm_params
    gc.collect()
    torch.cuda.empty_cache()

    mark("phase 10")
    # 8. the lifecycle: measured autotuning, the cache, donation, the
    #    session ladder, drift, the bundle, faults --------------------------
    for k, extra in lifecycle_phase(args, card).items():
        per_kernel[k].update(extra)
    gc.collect()
    torch.cuda.empty_cache()

    mark("phase 8")
    # 9. serving waves and the fleet, after phase 8's tensors are
    #    released: on a quarter of arxiv (phase 8's measured cells'
    #    matrices, LIFE_SCALE)
    a_uq, a_pq, b_hq = life_matrices(args)
    for k, extra in serving_phase(args, card, a_uq, a_pq, b_hq).items():
        per_kernel[k].update(extra)
    del a_uq, a_pq, b_hq

    mark("phase 9")
    # 11. SHIRO across two processes on the card: the smoke, the mp-*
    #     handles at arxiv scale, the supervisor's drills
    gc.collect()
    torch.cuda.empty_cache()
    for k, extra in mp_phase(args, card).items():
        per_kernel[k].update(extra)

    mark("phase 11")
    # 12. training (GCN, GAT) and the expert-parallel LM across the two
    #     processes
    release_host_memory()
    for k, extra in mp_train_phase(args, card).items():
        per_kernel.setdefault(k, {}).update(extra)

    mark("phase 12")
    # 13. LM training: OLMoE-1B-7B (2 layers) dense and expert-parallel,
    #     smollm-135m through the training launcher
    gc.collect()
    torch.cuda.empty_cache()
    for k, extra in train_lm_phase(args, card).items():
        per_kernel.setdefault(k, {}).update(extra)

    mark("phase 13")
    # 14. falcon-mamba-7b serving: the SSM family at full width, after
    #     every earlier phase's weights are released
    gc.collect()
    torch.cuda.empty_cache()
    per_kernel.setdefault("rmsnorm", {}).update(
        family_serve(args, card, *SSM_CELL)[0])

    mark("phase 14")
    # 15. the hybrid (zamba2-2.7b), encdec (seamless-m4t-medium) and
    #     prefix (llava-next-mistral-7b) families at full width, and
    #     zamba2's 12-layer train check
    gc.collect()
    torch.cuda.empty_cache()
    for k, extra in family_phase(args, card).items():
        per_kernel.setdefault(k, {}).update(extra)

    mark("phase 15")
    # 16. the dry run's accounting against phases 13 and 15's steps, and
    #     two cells on the production grid
    dryrun_phase(args, card)

    mark("phase 16")
    rows = [kernel_summary(k, per_kernel[k], card) for k in KERNELS]
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
