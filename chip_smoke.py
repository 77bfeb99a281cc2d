#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--profile]

Phases, each printed on its own line:

1. The card's name and power limit (``nvidia-smi``), and the build of every
   hand-written kernel from the sources in ``src/repro_torch/kernels/csrc``;
   ``[fused_sass]``: the SASS instruction, FP32 and MUFU counts per element
   of the fused sweep's sample loops (``cuobjdump -sass`` of the built
   library); the FP32 and MUFU counts set the operation side of its bounds,
   and of the square kernel's (half of them per ordered pair);
   ``[pairwise_sass]``: the same counts of the square kernel's own sample
   loop (a diagnostic; it sets no bound); ``[fused_math_probe]``: the
   sample loop's device functions against float64 on 2,000,001 points
   (``expf`` and the polynomial ``log1p_unit`` within 2 ulp).
2. Kernel against plain, on the card: the fused triangular score kernel
   against its plain torch version at odd p, ragged n, dead rows holding
   NaN, and the full widths p=85/n=10000 and p=512/n=2000;
   ``[kernel_padding]``: a zero-padded launch with ``n_valid`` bit-identical
   to the unpadded one (max abs 0), on 16-byte aligned and unaligned rows.
   A case most of whose scores lie within their tolerance of 0 is refused.
3. ``repro_torch.fit`` on a small SEM against the float64 serial oracle, and
   at the E. coli core size (p=85, n=10000) with the kernel and with the
   plain square path: equal orders, equal B and noise variances, and one
   kernel launch per find-root.
4. ``fit`` at the iJR904 slice size (p=512, n=2000): the score vector of the
   fit's first iteration against the plain version, the kernel against plain
   at every smaller stage size on Gaussian rows under the fit's mask (the
   fit's own inputs there score ~0), the fit's wall time, and the kernel's
   time per launch at m=512, beside a no-math build's (the staging, sums and
   reduce alone).
5. The batched kernel (``fused_score_batch``) against its batched plain
   version: B=8 ragged E. coli-size datasets (p 70-85, n 8000-10000, dead
   rows holding NaN) in the (128, 16384) bucket and B=2 at (512, 2048), per
   dataset within ``score_tolerance`` and with the same root; row i of a
   batched launch bit-identical to ``fused_score_vector`` on dataset i;
   its time per call at B=8 (wrapper and kernel, the sweep's device time,
   a no-math build's time, tiles skipped and sample chunks swept against a
   padded sweep's), and the wrapper's mean time per call at each stage of
   one ``fit_batch`` dispatch of that bucket (m=128, 64, 32).
6. ``fit_batch`` on that E. coli bucket: ``hopper_fused`` and ``torch`` give
   equal orders, B and noise variances, and the batched kernel runs once per
   find-root (``p_pad - 1`` launches per dispatch).
7. The serving path: ``AsyncLingamEngine`` with real threads, two dispatcher
   replicas and both buckets pre-warmed serves 8 E. coli-size and 2
   iJR904-size requests from 3 submitter threads. Every ticket resolves,
   every result is bit-identical to a replay of its recorded dispatch
   through ``fit_batch``, the stats ledger balances, ``kernel_bypass`` and
   ``auto_downgrade`` are 0; requests/s, seconds per dispatch, and one
   ``fit`` per request for comparison are printed.
8. The square moments kernel (``pairwise_moments``, ``score_backend=
   "hopper"``) against its plain version, called as the pipeline calls it
   (live-row masks, valid counts; dead rows 0, samples past the valid count
   0): ragged p=13/n=700, a non-square block, masked p=37 with n_valid on a
   padded buffer, a masked non-square block, the E. coli fit's first stage
   (m=128, n=10000, the fit's mask), Gaussian m=512 n=2000; live
   off-diagonal sums within ``pairwise_score.sum_tolerance``, dead pairs
   exactly 0, entropies within 1e-5; zero-padding of n bit-exact, and a
   padded launch with ``n_valid`` (zeros or NaN past it) bit-identical to
   the unpadded launch; row b of a masked B=8 launch at the (128, 16384)
   bucket bit-identical to a one-dataset launch; times per launch (masked,
   unmasked, a no-math build) against the live work's bound, the padded
   buffer's beside it, with the lane count and resident blocks per SM.
9. ``fit(score_backend="hopper")`` at the E. coli core size (84 launches,
   the orders of ``hopper_fused`` and ``torch``), the host driver
   ``causal_order`` with both kernels (the order of ``fit``), and
   ``fit_batch(score_backend="hopper")`` on the E. coli bucket (127
   launches, the orders of phase 6). An order may depart from another only
   at an f32 near-tie of the dense scores (``fused_score.score_tolerance``).
10. The threshold mechanism: the E. coli example's configuration (p=85,
    n=10000, seed 7, chunk 16) through ``fit`` and the host driver, equal to
    each other and to the dense order, with comparisons, rounds and host
    reads; a p=8 threshold fit against the float64 oracle;
    ``fit_batch(threshold=True)`` on the E. coli bucket against each
    dataset's own ``fit_batch``; one served round of those requests through
    ``AsyncLingamEngine(ParaLiNGAMConfig(threshold=True))``, replayed.
11. The rank-1 update kernel (paper Algorithms 7 and 8). Its TPU mode
    (``update_data``, ``update_cov``) against its plain versions at the CPU
    tests' cases, p=85/n=10000 and p=512/n=2000, with times beside an empty
    kernel's on the same grid; then that mode's own path: 84 updates along
    the E. coli fit's order through ``kernels.ops``, each step held against
    the plain versions on the same inputs. (Run right after phase 3, whose
    order they take.) Its fit mode (``rank1_update``, one launch per scan
    iteration, on the path of every fit): ``[rank1_scale_probe]`` (its
    rsqrt against torch's, bit for bit), ``[rank1_update_vs_plain]`` on the
    inputs the fits give it (the E. coli dispatch's stages m=128, 64, 32,
    the E. coli and p=512 fits, |b| at and past 1): c' bit-equal, the
    scale within ``covupdate.SCALE_ULP_TOL`` ulp, padded columns +0, in
    place = out of place, and on forced plans (``FORCED_CASES``: each
    cluster size, several rows per block, odd n, a valid count ending
    mid-run, a row torch sums over 18 blocks, fewer than 16 rows);
    ``[update_plan]`` (the kernel's own plan of its data rows equals
    ``covupdate.update_plan``); ``[rank1_update_kernel_time]`` (the plan's
    path, cluster size and rows per block; device, event, out-of-place and
    empty-kernel ms beside the live bytes' bound and the plain composition;
    the stage split: ``no_sum_device_ms`` and ``no_cov_device_ms`` of
    builds without the sum's replay and without the correlation tiles,
    ``COV_VARIANTS``, timed out of place). Every fit line, ``[fit_batch_ecoli]``, the host
    driver and ``[engine]`` count its launches (p - 1 per fit, 127 per
    E. coli dispatch).
12. The SSD decode kernel against its plain version at Mamba2-370M's decode
    shape (B=4, H=32, P=64, N=128) and at ragged head counts, P not a
    multiple of the P-slice and N not a multiple of 4, new state bit-equal;
    row b of a B=4 launch bit-identical to a one-row launch (also at N=37,
    whose row views are not 16-byte aligned), a launch on inputs at a 4-byte
    offset (the scalar path) bit-identical to the aligned one, with times
    (kernel, wrapper, device); then
    Mamba2-370M at full width and depth (48 layers, vocab 50280, ~420M
    float32 weights from a seeded generator) through ``Engine.generate``:
    4 prompts of 32 tokens, 16 new tokens, 768 decode-kernel launches,
    greedy tokens equal to a CPU run of the same weights (or departing only
    at a near-tie of the CPU's top-2 logits, ``GAP_TOL``), prefill and
    decode-step seconds; the kernel against plain on the inputs of layers 0
    and 47 of a real decode step.
13. With ``--profile``: where one fit's time goes (torch.profiler device
    time by kernel, and the device's busy share), at both fit sizes and for
    the threshold fit; the torch ops and device kernels of one dense
    find-root of the E. coli bucket, and of ``fused_layout``, the plain
    version's torch prologue that the kernels now do themselves; those of
    the bucket's first update and of its whole scan per iteration, with the
    plain updates and with the update kernel (``[profile_scan_iteration]``); the
    device's busy share while the engine serves the same requests again,
    and the same for one Mamba2 ``generate``.
14. The messaging ring (``dist/ring.py``, ``dist/ring_order.py``; one card
    hosts one shard). ``[ring_block_kernel]``: the square kernel against its
    plain version on the row blocks the ring passes it at R = 2, 4, 8 and
    (P, R) = (2, 2), own against visiting rows and the reverse direction,
    at the E. coli fit's m=128 stage under its mask and at the m=512,
    n=2000 stage shape, on full n and on the two sample shards of n/2
    (whose sums add up to the full-n sums). ``[ring_ecoli]``: the E. coli
    core through ``causal_order_ring`` under an NCCL process group of one
    rank, dense and with the threshold (chunk 16), under ``hopper_fused``:
    the order of the scan with the same kernel (``hopper``), the run
    without a process group bit-equal, 84 square launches per dense order
    and 84 launches of the update kernel's ring mode per order, no
    collective under the group (a ``CollectiveLedger``: every dimension
    has one rank), ``wire`` all zero; ``[ring_fit]``: ``fit(order_backend="ring")`` with
    the scan fit's B and noise variances; ``[ring_find_root]``: the
    degenerate one-shard ``ring_find_root`` through one square launch, at
    the dense root; wall times beside the scan's there and at the iJR904
    slice (``[ring_slice]``, orders not held; its threshold run only with
    ``--profile``). ``[ring_update_kernel]`` (run after the fit-mode
    phase, before any rank process): the update kernel's ring mode against
    its plain version (the ring's torch update) on the E. coli core's first
    update, every row block of (P, R, M) = (1, 2, 1) and every block and
    sample shard of (1, 2, 2) (two launches around the sums' reduction),
    bit-equal out of place and in place, and under two plans it does not
    choose (``forced_plans_bit_equal``); its device ms per launch and
    stage split, the
    live bytes' bound and an empty kernel's floor on block 0 of each.
    ``[ring_sharded]``, last in the two- and four-rank sets of item 20 and
    reported after ``[ring_ecoli]``: ``causal_order_ring`` on the card over
    gloo at (1, 2, 1), (1, 4, 1), (2, 2, 1) and (1, 2, 2), the E. coli core
    dense at each, the threshold ring at (1, 2, 1) and (2, 2, 1), with
    ``--profile`` also the iJR904 slice dense at (1, 4, 1) (its time only:
    15-23 s per rank, the largest of the ring's jobs): every rank's order
    against the one-rank scan's (``hold_order``), ``wire`` against
    ``make_hier_plan``'s hop counts, kernel #3's launches on every rank
    against 1 + 2 per kept hop and find-root, the ring mode's against one
    per iteration (two with sample shards), the collectives by op and
    their seconds, seconds per order per rank beside the one-rank ring and
    the scan; ``[ring_fit]`` at (1, 2, 1) over the world ring; gloo's probe
    of each set also shifts a packet on the card around a ring of its
    ranks; ``[ring_sharded_jobs]``, their seconds against ``RING_JOBS_S``.
15. The attention families and the hybrid (``models/attention.py``,
    ``models/lm.py``; no hand kernel on the attention paths, the reference
    has none there). ``[granite_serve]``: granite-3-2b at full width and
    depth (40 layers, ~2.53B float32 weights from a seeded generator)
    through ``Engine.generate`` at the Mamba2 phase's shape, no kernel
    launched, two generates equal, the first 8 layers' tokens equal to a
    CPU run (or departing at a near-tie); ``[granite_serve_bf16]``: the
    same weights rounded to bfloat16, prefill logits within ``BF16_SHARE``
    of the largest float32 logit; ``[granite_serve_int8]``: the int8 KV
    cache, a decode's logits within ``INT8_SHARE`` of the largest of
    ``forward``'s, and the smoke model within the reference test's 0.05;
    ``[granite_prefill_long]``: a 1024-token prompt, blocked attention in 2
    chunks against ``causal_attention`` on layer 0; ``[gemma3_window]``:
    gemma3-12b at full width cut to one group (5 windowed layers of 1024 +
    1 global), a 2048-token prompt, the windowed blocked path and a decode
    past the window against the masked full form; ``[zamba2_serve]``:
    zamba2-2.7b at full width and depth (54 Mamba2 layers, the shared
    attention block 9 times), 864 decode-kernel launches and nothing else,
    the first group's tokens against a CPU run. With ``--profile``, the
    device's busy share of one granite and one zamba2 ``generate``.
16. MLA and MoE (``models/attention.py``'s ``mla_block``,
    ``models/moe.py``; no hand kernel, the reference has none there).
    ``[deepseek_serve]``: deepseek-v2-lite-16b at full width and depth (1
    dense MLA prologue layer + 26 MLA+MoE layers, 64 experts top-6 + 2
    shared, kv_lora 512), 15.71B bfloat16 weights from a seeded generator,
    their count against ``param_count()``, through ``Engine.generate`` at
    the serving shape: no kernel launched, two generates equal, the
    capacity's drops at the prefill (T·k = 768 > 256); ``[deepseek_cut]``:
    the prologue and the first 2 MoE groups upcast to float32, their routing
    at the prefill held on the card against the CPU, then their tokens
    against a CPU run, a departure allowed at a logit near-tie or at a
    routing near-tie (``[routing_near_tie]``: the CPU's k-th and (k+1)-th
    probabilities within ``ROUTE_TOL``) that can reach the departing row (its
    own token at a decode step; at the prefill its own tokens, or any where
    capacity drops couple the rows); ``[llama4_serve]``:
    llama4-scout-17b-a16e at full width cut to 8 of its 48 layers (listed as
    ``reduced``), 19.69B bfloat16 weights, the same checks;
    ``[llama4_moe_hold]``: its first layer's ``moe_ffn`` on the card against
    the CPU on a decode step's hidden states, within ``MOE_BF16_ULPS`` bf16
    ulps, when the host's RAM allows. With ``--profile``, the device's busy
    share of one deepseek ``generate`` and the kernels of one decode step.
17. The baselines (``core/ica_lingam.py``, ``core/poly_scores.py``).
    ``[ica_lingam]``: FastICA on the card against the CPU from the same
    start, at the E. coli core size (no convergence in 500 iterations:
    printed, not held) and on the easy p=5 SEM of the reference's test (W
    and order held), with ``fit``'s time beside it; ``[poly_scores]``: the
    polynomial scorer's times against ``find_root_dense`` under
    ``hopper_fused`` at E. coli core and the iJR904 slice, the hybrid root
    equal to the dense root.
18. The encoder-decoder family and training (``models/lm.py``'s
    ``"xattn"`` kind and ``_encode``, ``train/``; torch ops, no hand
    kernel, the reference has none there). ``[whisper_serve]``:
    whisper-base at full width and depth (6 encoder and 6 decoder layers,
    d_model 512, enc_len 1536, vocab 51865) in bfloat16 through
    ``Engine.generate(enc=)``, frames (4, 1536, 512) drawn after the
    prompts as ``launch.serve`` draws them: no kernel launched, two
    generates equal, the prefill's seconds (the encoder included, and the
    encoder alone), the decode step's, tokens/s, peak GB;
    ``[whisper_hold]``: the same in float32 against a CPU run, tokens equal
    or departing at a near-tie (``GAP_TOL``); ``[granite_train]``:
    granite-3-2b at full width and depth (2,534.0M float32 masters, the
    bfloat16 compute copy, remat in 5 superblocks of 8 groups) through
    ``trainer.train`` for 4 steps at ``launch.train``'s ``--batch 8 --seq
    128``: no kernel launched, finite losses, step 0 below
    1.2·log(vocab_padded), the seconds of each step (the first apart),
    tokens/s, peak GB, and the GB its forward keeps for the backward with
    and without remat;
    ``[granite_train_hold]``: full width cut to 2 layers and a batch of 2
    (``reduced``), one step on the card against the CPU from the same
    weights and tokens under the split hold (the loss and each leaf's
    gradient within bfloat16 tolerances; ``adamw_update`` on the same
    gradients within float32 rounding), the GB kept for the backward and
    the peak, with and without remat;
    ``[train_resume]``: granite ``--preset 100m`` stopped at step 3 and
    resumed to 6 against an uninterrupted run: the checkpoint bit for bit,
    the losses within ``RESUME_LOSS_RTOL``. With ``--profile``, the device
    kernels and busy share of one whisper ``generate`` and of one granite
    training step.
19. Sharded training (``dist/sharding.py``, ``launch.train --data-shards
    --model-shards``; torch ops and collectives, no hand kernel), after
    the threshold fits (item 10), so that the slice's fit starts inside
    its elapsed-time gate. Ranks are processes started here (``spawn``),
    one set per world size running its jobs in turn, each job on its own
    grid's mesh (two ranks: the (1, 2) jobs, then the (2, 1) ones; four:
    the (2, 2) ones; three: the (1, 3) ones, item 20;
    ``[sharded_ranks]``: the set's grids, its seconds and
    the script's elapsed seconds), one card each under
    NCCL when the machine has a card per rank, else all on the one card
    over gloo with CUDA tensors (``backend=``, ``cards=``); a rank that
    fails or outlives ``RANK_TIMEOUT`` fails the phase. Under gloo each set
    first checks that its ``all_reduce``, ``all_gather``, ``broadcast`` and
    ``reduce_scatter`` take CUDA tensors (``[gloo_cuda_probe]``).
    ``[granite_train_tp]``:
    granite-3-2b at full width and depth through ``launch.train.run`` with
    ``--model-shards 2`` and its defaults (8 × 128, lr 3e-4, 20 warmup
    steps), 4 steps: per-rank peak GB, seconds per step, tokens/s, the
    seconds inside collectives, and the losses beside ``[granite_train]``'s
    (the same weights and batches; each within ``BF16_LOSS_ATOL``).
    ``[train_sharded_hold]``: granite at full width cut to 2 layers, 4 ×
    128, float32, at (data, model) = (1, 2), (2, 1), (2, 2) with ZeRO-1
    where data > 1: the loss, every gathered gradient and every parameter
    after one AdamW step against the one-rank run on the card, within
    ``SHARD_TOL`` of each leaf's norm. ``[deepseek_ep_hold]``: deepseek at
    full width, the prologue and 2 MoE groups in float32, 4 × 128 (T·k =
    3072: capacity drops), at (1, 2) (experts and MLA heads split) and (2,
    1) (global routing): the routing of every MoE layer against the
    one-rank run's (a flip only at a ``ROUTE_TOL`` near-tie,
    ``[routing_near_tie]``), then the loss and every gathered gradient
    within ``SHARD_TOL``. Each job prints its seconds (``job_s``).
    ``[train_sharded_hold]`` also runs mamba2 (2 layers), zamba2 (one
    group) and whisper-base (whole) at full width at (1, 2) and (2, 2),
    each gradient within ``SHARD_TOL`` of its norm or within
    ``REORDER_FACTOR`` times its float32 floor (the one-rank gradient
    summed in another order), whichever is larger. FSDP (the reference's
    train cell: every leaf the data ranks divide cut over ``data`` too,
    gathered where the model reads it, its gradient reduce-scattered;
    ``dist.sharding.with_fsdp``): ``[granite_train_fsdp]``, granite-3-2b
    at full width and depth through ``trainer.train`` at (data, model) =
    ``FSDP_GRID`` = (2, 1), ``[granite_train]``'s weights, batches and optimizer,
    ``FSDP_STEPS`` steps: per rank the argument and peak GB beside
    ``[granite_train_tp]``'s, seconds per step, tokens/s, the collectives
    per step by op and their seconds, the losses within ``BF16_LOSS_ATOL``
    of ``[granite_train]``'s; ``[train_fsdp_hold]``, granite cut to
    ``SHARD_CUT`` layers and deepseek to its prologue and 2 MoE groups, in
    float32 at (2, 1) and (2, 2): the loss equal bit for bit to the same
    grid's without FSDP, every gradient and every parameter after one
    AdamW step (in place on the FSDP shards, no ZeRO-1 slice) within
    ``SHARD_TOL`` of the one-rank leaf's norm, each rank running the
    one-rank step in turn and holding its own pieces
    (``fsdp_and_one_rank``: no full leaf on the wire; at (2, 2)
    deepseek's one-rank run routes each batch shard alone,
    ``moe_local_capacity``). Context parallelism (the reference's
    ``cp_seq``: ``with_context_parallel``, each model rank its block of
    the sequence with every head) at ``CP_GRID`` = (1, 2):
    ``[granite_prefill_cp]``, granite-3-2b at full width and depth in
    float32, B = 2 prompts of 2048: its seconds, collectives by op and
    their seconds, arguments and peak per rank, its last logits within
    ``SHARD_TOL`` of the one-rank prefill's and its split-KV caches of the
    tensor-parallel prefill's, then 8 greedy tokens under the plain rules
    on its caches against the one-rank run's (``GAP_TOL`` rule);
    ``[granite_train_cp]``, granite at full width cut to
    ``CP_TRAIN_LAYERS`` layers through ``trainer.train``, 2 steps of 2 ×
    2048, its losses within ``BF16_LOSS_ATOL`` of the one-rank run's;
    ``[train_cp_hold]`` at (1, 2) and, under FSDP, at (2, 2): granite (2
    layers), gemma3 (one group, its attention at full width: the window,
    cut to 8; 32768 vocabulary rows, 3840 MLP columns), deepseek
    (the prologue and 2 MoE groups) and whisper-base, float32, the loss,
    gradients and one AdamW step within ``SHARD_TOL`` of one rank's
    (``fsdp_and_one_rank(cp=True)``); ``[cp_jobs]``, their seconds
    against ``CP_JOBS_S``.
20. Sharded serving (``Engine(rules=)``, split-KV caches, the SSM's heads
    over ``model``; the decode kernel on each rank's heads) in the same
    sets of ranks. ``[granite_serve_tp]`` and ``[zamba2_serve_tp]``: the
    two models at full width and depth in float32 over (data, model) =
    (1, 2), B=4 prompts of 32, 16 greedy tokens: the tokens equal on both
    ranks and equal to ``[granite_serve]``'s and ``[zamba2_serve]``'s, or
    departing at a near-tie (``[token_departure]``, ``GAP_TOL``); tokens/s,
    seconds per decode step, collectives per step and their seconds, peak
    GB per rank; zamba2's decode kernel counted per rank (54 per step, each
    on 40 heads). ``[sharded_serve_hold]`` at (1, 2), (2, 1), (2, 2):
    granite (and its int8 KV cache) and deepseek cut at full width, gemma3
    at full width over one group and one window of prompt, mamba2, zamba2
    and whisper at smoke size, float32: the caches after the prefill and
    every step's logits against the one-rank run on the card fed the same
    tokens, within ``SHARD_TOL`` of their norms (the int8 cache: its
    values within ``INT8_STEP``, its logits within ``INT8_LOGIT_TOL`` of
    their norm and every argmax equal), routing flips only at near-ties,
    which excuse the logits from their step on. Then the decode kernel
    against its plain version on a zamba2 step's inputs of model rank 0
    (B=4, H=40, P=64, N=64) and its times at that shape; its device time
    there is taken last (item 21). Three ranks at (data, model) =
    ``UNEVEN_GRID`` = (1, 3), whose model ranks hold balanced, uneven
    blocks of the heads (``attention.head_block``), the MLP's columns and
    the padded vocabulary: ``[granite_serve_uneven]`` (granite-3-2b at full
    width and depth, heads 11/11/10, blocks that cut across its GQA groups
    of 4) and ``[whisper_serve_uneven]`` (whisper-base, heads 3/3/2) as
    ``[granite_serve_tp]`` runs, each rank's block checked, the tokens
    against ``[granite_serve]``'s and against whisper-base's float32
    one-rank tokens on the card (``[whisper_hold]``'s model) by the same
    near-tie rule; then ``[train_sharded_hold]`` at (1, 3) for granite
    (2 layers) and whisper-base (whole). Last in the two-rank set, the
    batched estimator sharded over the data ranks:
    ``[fit_batch_data_sharded] grid=2x1`` (``fit_batch(rules=)`` on the
    ragged E. coli bucket under ``hopper_fused``, and on the two
    iJR904-size requests: every rank's gathered orders, B, noise
    variances, comparisons, rounds and convergence bit for bit the one-rank
    ``fit_batch``'s of phase 6 (the threshold bucket at 2 x 1, 15.3 s, was
    cut to make room for phase 23); seconds per dispatch, kernel #2's and the update
    kernel's launches and the all-gather's bytes and seconds per rank) and
    ``[engine_data_sharded]`` (``AsyncLingamEngine(rules=)`` pre-warmed at
    every batch count, 3 submitter threads on the leader serving the 10
    requests of item 7 over 2 replicas: every fit bit for bit item 7's,
    launches counted on both ranks, a follower's submit refused); in the
    four-rank set ``[fit_batch_data_sharded] grid=4x1`` (the E. coli
    bucket, and 6 of its requests through ``dispatch_bucket(rules=)``,
    padded to 8); ``[lingam_sharded_jobs]``, their seconds against
    ``LINGAM_JOBS_S``.
21. After every other phase, ``[ssd_decode_device_time]``: kernel #6's
    device time at the per-rank shape, from a torch.profiler session in a
    process of its own (a session in a process that ran ranks, or in a
    rank, left later sessions of the main process without device events).
22. ``[dryrun_hold]``, after every timed phase: the production dry run
    (``launch/dryrun.py``: one rank's cell on fake tensors over a fake
    process group, nothing allocated) of the cells this run measured, at
    their own shapes and meshes, each rank traced as itself in a pool of
    ``DRYRUN_WORKERS`` processes, held against the measurements:
    ``[granite_train]`` (one rank), ``[granite_train_tp]`` (both ranks of
    (1, 2)), ``[granite_train_fsdp]`` (rank 0 of (2, 1),
    ``FSDP_TRACED_RANKS``: its ``fsdp_axes`` and its collectives per step
    by op too) and
    ``[granite_serve_tp]``/``[zamba2_serve_tp]`` (both ranks; the prefill
    and a decode step with its logits' gather) and ``[granite_serve_uneven]``
    (ranks 0 and 2 of (1, 3), 11 and 10 heads; each record's head block
    equal to the rank's): collectives per step equal
    to a ``CollectiveLedger``'s count (``CollectiveClock`` on the ranks),
    argument bytes equal to the real tensors'
    (``StepArguments``), each predicted peak within ``PEAK_TOL`` of the
    rank's ``max_memory_allocated``, the predicted temporaries (peak less
    arguments) within ``TEMP_TOL`` of the measured ones (less the bytes
    held beside the run, ``Beside``), kernel #6's launches per step equal
    to the counted ones; and ``[dryrun_production]``, yi-34b/decode_32k on
    the 16 x 16 mesh as rank 1 (q heads 4-7 of 56, across two GQA groups),
    traced in the same pool, and its record (``[dryrun_record]``, which
    must be ``ok``); and rank 0 of ``[granite_prefill_cp]`` and
    ``[granite_train_cp]``, built as ``REPRO_OPT=cp_seq`` builds them
    (``cp_dry_record``; ``hold_cp_cells``: the collectives by op, the
    argument bytes, the peak and the temporaries). The phase's seconds
    stay under ``DRYRUN_HOLD_S``.
23. The estimator in float64 (``ParaLiNGAMConfig(dtype=torch.float64)``).
    ``[fit_f64]``: the E. coli core's float64 fit under ``torch`` gives the
    float64 serial oracle's order (``ECOLI_F64_ORDER``); under
    ``hopper_fused`` (kernel #1 on float32 copies of the float64 state) the
    order of ``torch_fused``, or a departure at an f32 near-tie; where each
    first departs from the oracle's order; p - 1 kernel launches and no
    update-kernel launch (``dispatch_stats["rank1_update"]`` 0); the
    seconds beside the float32 fit's. ``[fit_batch_f64]``: 3 ragged E.
    coli-size requests in one float64 bucket, each row bit for bit its own
    one-dataset ``fit_batch``, its order a dedicated float64 ``fit``'s.
24. ``[smoke_wall]``: the script's seconds so far. Then a
    ``{"kernels": [...]}`` line with each hand kernel's launches on its
    path (the square kernel's ring launches beside them, one rank's and
    each rank's of ``[ring_sharded]``; the update kernel's ring mode's
    launches, error and times; the decode kernel's zamba2 launches, one
    rank's and two ranks'), its error
    against the plain version, its time, the plain version's time and
    its bound.

``fit_batch`` phases also hold each dataset's order, B and noise variances
bit for bit against its own one-dataset ``fit_batch``.

Every failed check raises, and the script exits non-zero without printing a
result. It needs a CUDA device (it exits non-zero without one) and imports
neither JAX nor the JAX package. The last line of its output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import multiprocessing as mp
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import direct_lingam, sem  # noqa: E402
from repro_torch.core.covariance import cov_matrix, normalize  # noqa: E402
from repro_torch.core.pairwise import fused_layout  # noqa: E402
from repro_torch.core import paralingam  # noqa: E402
from repro_torch.core.paralingam import (  # noqa: E402
    ParaLiNGAMConfig,
    causal_order,
    fit,
    fit_batch,
)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import covupdate as cu  # noqa: E402
from repro_torch.kernels import fused_score as fs  # noqa: E402
from repro_torch.kernels import pairwise_score as ps  # noqa: E402
from repro_torch.kernels import ssd_decode as sd  # noqa: E402
from repro_torch import configs, measure  # noqa: E402
from repro_torch.core import ica_lingam as ica  # noqa: E402
from repro_torch.core import poly_scores as poly  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import embed, rmsnorm  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AsyncLingamEngine,
    BatchingConfig,
    LingamServeConfig,
)
from repro_torch.serve.buckets import bucket_dim  # noqa: E402
from repro_torch.dist.ring_order import causal_order_ring  # noqa: E402
from repro_torch.serve.lingam_engine import pack_bucket  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.launch.train import preset_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.dist.sharding import (  # noqa: E402
    gather_over_model,
    with_context_parallel,
    with_fsdp,
)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as cell_specs  # noqa: E402
from repro_torch.launch.mesh import fake_world, production_shape  # noqa: E402
from repro_torch.train import trainer as trainer_mod  # noqa: E402
from repro_torch.utils.collectives import CollectiveLedger  # noqa: E402
from repro_torch.train import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig, adamw_update, init_opt_state  # noqa: E402
from repro_torch.train.trainer import TrainerConfig, loss_and_grads, make_train_step, train  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    param_count,
    tree_flatten_with_names,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

# Kernel against plain: the same root, and per live row the error bound of
# fused_score.score_tolerance — float32 rounding of each entropy carried
# through I and S = sum min(0, I)^2. Both sides take the same float32
# formulas and differ only in the order of the sample sums (per-thread chunk
# sums vs torch's tree reduction) and of the tile sums.
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3 bytes/s,
# FP32 FLOP/s outside the tensor cores, and special-function results/s
# (132 SMs x 16 per clock x 1.98 GHz: the transcendentals' pipe).
HBM_BPS, FP32_FLOPS, SFU_OPS = 3.35e12, 67e12, 132 * 16 * 1.98e9
# FP32 instructions per second: one FFMA, FMUL or FADD per FP32 lane per
# clock (132 SMs x 128 lanes x 1.98 GHz), the FP32 peak counting an FFMA as 2.
FP32_INSNS = FP32_FLOPS / 2
# SASS counts of the fused sweep, per (unordered pair, sample) of the tile
# loop and per sample of the row-entropy loop: (FP32, MUFU) instructions,
# from ``cuobjdump -sass`` of the built library in this run (phase_sass).
SWEEP_SASS = {}
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused_score.cu"
KERNEL_REPLACES = "src/repro/kernels/fused_score.py:70"
BATCH_REPLACES = "src/repro/kernels/fused_score.py:208"
# The serving buckets: E. coli core size (p=85, n=10000) and the iJR904
# slice (p=512, n=2000), under LingamServeConfig's pow-2 grid.
ECOLI_BUCKET, IJR_BUCKET = (128, 16384), (512, 2048)
# The E. coli core size and the iJR904 slice of bench_table2.py, (p, n).
ECOLI, SLICE = (85, 10_000), (512, 2000)


def say(tag: str, **kw):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def normalized(x, dev, dtype=torch.float32):
    xn = normalize(torch.as_tensor(x, dtype=dtype, device=dev))
    return xn, cov_matrix(xn)


def compare(name, xn, c, mask, **kw):
    """Kernel vs plain on the card; returns the max absolute difference."""
    s_k = fs.fused_score_vector(xn, c, mask, **kw)
    s_r = fs.fused_score_vector_ref(xn, c, mask, block=kw.get("block", 8),
                                    n_valid=kw.get("n_valid"))
    torch.cuda.synchronize()
    return hold(name, s_k, s_r, xn, c, mask, kw.get("n_valid"))


def hold(name, s_k, s_r, xn, c, mask, n_valid=None):
    """One dataset's kernel scores against its plain scores: dead rows +inf,
    every live row within ``score_tolerance``, the same root, and most rows
    farther than their tolerance from 0. Returns the max absolute error."""
    check(bool(torch.all(torch.isinf(s_k[~mask]))), f"{name}: dead rows not +inf")
    k, r = s_k[mask].double(), s_r[mask].double()
    check(bool(torch.all(torch.isfinite(k))), f"{name}: non-finite live scores")
    err = (k - r).abs()
    tol = fs.score_tolerance(s_r, xn, c, mask, n_valid=n_valid)[mask].double()
    # A row whose score is within its tolerance of 0 would pass a kernel that
    # wrote zeros there; a case tests the kernel only if most rows are not so.
    held = int(torch.sum(r.abs() > tol))
    ok = bool(torch.all(err <= tol)) and int(torch.argmin(s_k)) == int(torch.argmin(s_r))
    say("kernel_vs_plain", case=name, p=xn.shape[0], n=xn.shape[1],
        max_abs=f"{err.max().item():.3e}", max_abs_over_max_S=f"{err.max().item() / r.abs().max().item():.3e}",
        max_err_over_tol=f"{(err / tol).max().item():.3e}",
        rows_above_tol=f"{held}/{r.numel()}", ok=ok)
    check(2 * held > r.numel(),
          f"{name}: most live scores are within their tolerance of 0, so the case cannot fail")
    check(ok, f"{name}: kernel disagrees with plain")
    return err.max().item()


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernel(dev) -> float:
    errs = []
    # odd p, ragged n, dead rows holding NaN
    xn, c = normalized(np.random.default_rng(1).standard_normal((37, 1300)), dev)
    mask = torch.arange(37, device=dev) % 5 != 2
    xn = torch.where(mask[:, None], xn, torch.nan).contiguous()
    c = torch.where(mask[:, None] & mask[None, :], c, torch.nan).contiguous()
    errs.append(compare("odd_p_dead_nan", xn, c, mask))
    # n_valid padding: the kernels stop at the valid count, so a zero-padded
    # launch gives the bits of the unpadded one (n=700 rows 16-byte aligned,
    # n=1901 rows not: the 4-byte staging path)
    diffs = []
    for p, n, n_pad, seed in ((21, 700, 1024, 2), (19, 1901, 2048, 3)):
        xn, c = normalized(np.random.default_rng(seed).standard_normal((p, n)), dev)
        xp = torch.zeros((p, n_pad), device=dev)
        xp[:, :n] = xn
        mask = torch.ones(p, dtype=torch.bool, device=dev)
        nv = torch.tensor(n, device=dev)
        errs.append(compare(f"n_valid_pad_n{n}", xp, c, mask, n_valid=nv))
        s_pad = fs.fused_score_vector(xp, c, mask, n_valid=nv).double()
        s_exact = fs.fused_score_vector(xn, c, mask).double()
        diffs.append((s_pad - s_exact).abs().max().item())
    ok = max(diffs) == 0.0
    say("kernel_padding", cases="p21_n700_pad1024,p19_n1901_pad2048",
        padded_vs_unpadded_max_abs=f"{max(diffs):.3e}".replace("0.000e+00", "0"), ok=ok)
    check(ok, "n_valid padding changed the kernel's scores")
    # full widths: the fits' SEM data, and at p=512 well-conditioned Gaussian
    # data (the p=512 SEM holds near-collinear pairs whose scores are f32
    # noise). Gaussian data at n=10000 has scores ~1e-9, below the float32
    # rounding of the entropies they come from, so it cannot be held.
    for p, n, seed in ((85, 10_000, 0), (512, 2000, 1)):
        x = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=seed))["x"]
        cases = [(f"sem_p{p}_n{n}", x)]
        if p == 512:
            cases.append((f"gauss_p{p}_n{n}", gauss_data(p, n, seed)))
        for name, data in cases:
            xn, c = normalized(data, dev)
            errs.append(compare(name, xn, c,
                                torch.ones(xn.shape[0], dtype=torch.bool, device=dev)))
    return max(errs)


def gauss_data(p, n, seed):
    return np.random.default_rng(seed).standard_normal((p, n))


def phase_sass():
    """The fused sweep's instruction counts from the SASS of its built
    library: the tile loop per (unordered pair, sample), both directions
    (4 libdevice ``expf`` = 4 MUFU.EX2 each), and the row-entropy loop per
    sample (2 EX2). Their FP32 arithmetic and MUFU counts set the operation
    side of the kernels' bounds (the square kernel's too, at half the tile
    loop's per ordered pair); loads, integer address arithmetic, moves and
    loop control are printed, not counted. Then the square kernel's own
    loop, per (ordered pair, sample)."""
    sass = measure.dump(_build.library_path("fused_score"))
    for key, kernel, ex2 in (("tiles", "fused_tri_tiles", 4), ("rows", "row_entropies", 2)):
        got = measure.sample_loop(sass, kernel, ex2)
        SWEEP_SASS[key] = (got.fp32, got.mufu)
        hist = ",".join(f"{k}:{v}" for k, v in got.loop.histogram().most_common())
        say("fused_sass", kernel=kernel, instructions_per_element=f"{got.instructions:g}",
            fp32_per_element=f"{got.fp32:g}", mufu_per_element=f"{got.mufu:g}",
            loop_instructions=len(got.loop.ops), ops=hist)
    # The square kernel's sample loop per (ordered pair, sample): one
    # direction of the fused loop's math (2 EX2). Printed, not counted.
    got = measure.sample_loop(measure.dump(_build.library_path("pairwise_moments")),
                              "pairwise_moments_tiles", 2)
    hist = ",".join(f"{k}:{v}" for k, v in got.loop.histogram().most_common())
    tf, tm = SWEEP_SASS["tiles"]
    say("pairwise_sass", kernel="pairwise_moments_tiles",
        instructions_per_element=f"{got.instructions:g}", fp32_per_element=f"{got.fp32:g}",
        mufu_per_element=f"{got.mufu:g}", loop_instructions=len(got.loop.ops), ops=hist,
        fused_fp32_per_direction=f"{tf / 2:g}", fused_mufu_per_direction=f"{tm / 2:g}")


def sweep_bound_ms(pair_samples: float, row_samples: float, bytes_moved: float):
    """(bound, bytes, FP32, SFU) ms of the fused sweep on this much work:
    the live (unordered pair, sample) elements of the tiles, the live (row,
    sample) elements of the row entropies, the bytes read once."""
    (tf, tm), (rf, rm) = SWEEP_SASS["tiles"], SWEEP_SASS["rows"]
    t_bytes = bytes_moved / HBM_BPS * 1e3
    t_fp32 = (tf * pair_samples + rf * row_samples) / FP32_INSNS * 1e3
    t_sfu = (tm * pair_samples + rm * row_samples) / SFU_OPS * 1e3
    return max(t_bytes, t_fp32, t_sfu), t_bytes, t_fp32, t_sfu


# The sample loop's share of a kernel's time, measured: a build of a kernel
# source whose log cosh and u exp(-u^2/2) return their argument, with a copy
# of the shared header edited by text substitution, both written into the
# git-ignored build directory (the sources have no such variant). What it
# leaves is the staging, residuals, sums and reduce.
NO_MATH = (("  return a + log1p_unit(expf(-2.f * a)) - kLn2;", "  return u;"),
           ("  return u * expf(-0.5f * (u * u));", "  return u;"))
MATH_HEADER = "lingam_math.cuh"


@functools.cache
def no_math_library(name: str):
    """The no-math build of ``csrc/<name>.cu``, loaded."""
    header = (_build.CSRC / MATH_HEADER).read_text()
    for old, new in NO_MATH:
        check(old in header, f"no-math build: {old!r} is not in {MATH_HEADER}")
        header = header.replace(old, new)
    out = _build.BUILD_DIR / "no_math"
    out.mkdir(parents=True, exist_ok=True)
    (out / MATH_HEADER).write_text(header)  # found first: beside the source
    (out / f"{name}.cu").write_text((_build.CSRC / f"{name}.cu").read_text())
    lib = out / f"lib{name}_no_math.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(out / f"{name}.cu")],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


def no_math_ms(fn, reps: int, module=fs) -> float:
    """``fn``'s time per call with the no-math build of ``module``'s kernel
    library in place of the real one (its results are not read)."""
    name, symbol = {fs: ("fused_score", "fused_score_launch"),
                    ps: ("pairwise_moments", "pairwise_moments_launch")}[module]
    real = module._entry
    bare = getattr(no_math_library(name), symbol)
    bare.argtypes, bare.restype = real().argtypes, ctypes.c_int
    module._entry = lambda: bare
    try:
        return time_ms(fn, reps)
    finally:
        module._entry = real


def ulps(got, want64):
    """|got - want| in units of the float32 spacing at want (float64)."""
    w32 = want64.float()
    spacing = (torch.nextafter(w32.abs(), torch.tensor(torch.inf, device=w32.device))
               - w32.abs()).double()
    return (got.double() - want64).abs() / spacing


def phase_math_probe(dev):
    """The sample loop's device functions against float64 on 2,000,001
    points u in [-60, 60]: libdevice ``expf`` of -2|u| and the kernel's
    polynomial ``log1p_unit`` of that float32 value, each within 2 ulp;
    log cosh of +-0 exactly 0 (the kernel has no select for it); and
    log cosh u and u exp(-u^2/2), whose float64 values they approximate
    through the formula the plain version shares (printed, not held: near
    u = 0, |u| + log1p(e) - log 2 cancels in every float32 implementation)."""
    u = torch.linspace(-60, 60, 2_000_001, dtype=torch.float64, device=dev).float()
    e, l1p, lc, ue = fs.math_probe(u)
    u64 = u.double()
    a = u64.abs()
    err_exp = ulps(e, torch.exp(-2 * a)).max().item()
    err_l1p = ulps(l1p, torch.log1p(e.double())).max().item()
    lc64 = a + torch.log1p(torch.exp(-2 * a)) - np.log(2.0)
    lc_abs = (lc.double() - lc64).abs().max().item()
    ue_abs = (ue.double() - u64 * torch.exp(-0.5 * u64 * u64)).abs().max().item()
    zero = fs.math_probe(torch.tensor([0.0, -0.0], device=dev))[2]
    ok = err_exp <= 2 and err_l1p <= 2 and bool(torch.all(zero == 0))
    say("fused_math_probe", points=u.numel(), expf_max_ulp=f"{err_exp:.3f}",
        log1p_unit_max_ulp=f"{err_l1p:.3f}", log_cosh_max_abs=f"{lc_abs:.3e}",
        u_exp_max_abs=f"{ue_abs:.3e}", log_cosh_at_0=f"{zero.abs().max().item():g}", ok=ok)
    check(ok, "a device function of the sample loop is more than 2 ulp from float64, "
              "or log cosh 0 is not exactly 0")


def fit_stage_inputs(x, dev):
    """Fit once with ``hopper_fused`` and keep the find-root inputs of the
    first iteration of every stage, keyed by the stage's buffer size."""
    captured = {}
    orig = ops.score_vector

    def spy(xn, c, mask, **kw):
        if xn.shape[0] not in captured:
            captured[xn.shape[0]] = (xn.clone(), c.clone(), mask.clone())
        return orig(xn, c, mask, **kw)

    ops.score_vector = spy
    try:
        res, _, seconds, _, _ = run_fit(x, "hopper_fused", dev)
    finally:
        ops.score_vector = orig
    return captured, res, seconds


def run_fit(x, backend, dev, **kw):
    """One ``fit``: (result, B, seconds, fused-kernel launches, update-kernel
    launches), the counts set to 0 just before it."""
    fs.LAUNCHES = cu.RANK1_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, b = fit(x, ParaLiNGAMConfig(score_backend=backend, **kw), device=dev)
    torch.cuda.synchronize()
    return res, b, time.perf_counter() - t0, fs.LAUNCHES, cu.RANK1_LAUNCHES


def phase_fit_small(dev):
    data = sem.generate(sem.SemSpec(p=8, n=2500, density="sparse", seed=0))
    res, b, _, launches, updates = run_fit(data["x"], "auto", dev, min_bucket=8)
    oracle = direct_lingam.causal_order(data["x"])
    say("fit_small", p=8, n=2500, order_equals_f64_oracle=res.order == oracle,
        launches=launches, update_launches=updates)
    check(res.order == oracle, "fit order differs from the float64 oracle at p=8")
    check(launches == 7 and updates == 7,
          "fit did not run the score and update kernels once per iteration")
    check(bool(torch.all(torch.isfinite(b))) and tuple(b.shape) == (8, 8),
          "B is not a finite (8, 8) matrix")


def phase_fit_core(dev, gpu) -> float:
    p, n = ECOLI
    data = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=0))
    captured, warm, _ = fit_stage_inputs(data["x"], dev)
    res_k, b_k, t_k, launches, updates = run_fit(data["x"], "hopper_fused", dev)
    res_p, b_p, t_p, _, plain_updates = run_fit(data["x"], "torch", dev)
    same = res_k.order == res_p.order
    b_err = (b_k - b_p).abs().max().item()
    nv_err = float(np.max(np.abs(res_k.noise_var / res_p.noise_var - 1)))
    say("fit_ecoli_core", p=p, n=n, orders_equal=same, b_max_abs_diff=b_err,
        noise_var_max_rel_diff=nv_err, launches=launches, find_roots=p - 1,
        update_launches=updates, update_launches_torch=plain_updates,
        valid_order=sem.is_valid_causal_order(res_k.order, data["b_true"]),
        fit_s_hopper_fused=f"{t_k:.3f}", fit_s_torch=f"{t_p:.3f}", gpu=f"'{gpu}'")
    check(same, "hopper_fused and torch orders differ at p=85")
    # Same order and same raw data: phase 2 sees identical inputs.
    check(b_err <= 1e-6 and nv_err <= 1e-6, "B or noise_var differ at p=85")
    check(launches == p - 1, f"{launches} kernel launches for {p - 1} find-roots")
    check(updates == p - 1 and plain_updates == 0,
          f"{updates} update launches for {p - 1} iterations ({plain_updates} on torch)")
    check(res_k.order == warm.order, "two fits of the same data gave different orders")
    check(bool(torch.all(torch.isfinite(b_k))) and np.all(np.isfinite(res_k.noise_var)),
          "non-finite B or noise variances")
    err = max(compare(f"fit85_stage_m{m}", *captured[m]) for m in sorted(captured, reverse=True))
    return err, {"x": data["x"], "hopper_fused": (res_k, b_k, t_k), "torch": (res_p, b_p, t_p)}


def phase_fit_slice(dev, gpu):
    """Returns (launches, max_abs_err, kernel ms, plain ms, bound ms, extra)."""
    p, n = 512, 2000
    x = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=1))["x"]
    captured, warm, t_warm = fit_stage_inputs(x, dev)  # the warm-up fit
    res, b, t_fit, launches, updates = run_fit(x, "hopper_fused", dev)  # the main path
    say("fit_ijr904_slice", p=p, n=n, launches=launches, find_roots=p - 1,
        update_launches=updates,
        fit_s=f"{t_fit:.4f}", warmup_fit_s=f"{t_warm:.4f}",
        same_order_as_warmup=res.order == warm.order, gpu=f"'{gpu}'")
    check(launches == p - 1 and updates == p - 1,
          f"{launches} kernel and {updates} update launches for {p - 1} iterations")
    check(res.order == warm.order, "two fits of the same data gave different orders")
    check(bool(torch.all(torch.isfinite(b))), "non-finite B at p=512")
    # The fit's own find-root inputs are held at m=512 only: from the m=256
    # stage on, this SEM's live correlations are all +-1 in float32 and every
    # score is ~0, a comparison that cannot fail. The smaller stages are held
    # on Gaussian rows cut to the stage size, under the fit's mask there.
    errs = [compare(f"fit512_stage_m{p}", *captured[p])]
    gauss = gauss_data(p, n, 1)
    for m in sorted((m for m in captured if m < p), reverse=True):
        xn, c, mask = captured[m]
        s_fit = fs.fused_score_vector_ref(xn, c, mask)[mask]
        say("fit512_stage_degenerate", m=m, live=int(mask.sum()),
            max_abs_S=f"{s_fit.abs().max().item():.3e}", held=False)
        xn, c = normalized(gauss[:m], dev)
        xn = torch.where(mask[:, None], xn, torch.nan).contiguous()
        c = torch.where(mask[:, None] & mask[None, :], c, torch.nan).contiguous()
        errs.append(compare(f"gauss_stage_m{m}", xn, c, mask))

    xn, c, mask = captured[p]
    ms = time_ms(lambda: fs.launch(xn, c, mask), reps=50)
    wrapper_ms = time_ms(lambda: fs.fused_score_vector(xn, c, mask), reps=20)
    tiles_ms = device_ms(lambda: fs.launch(xn, c, mask), "fused_tri_tiles", reps=10)
    queued_ms = queued_event_ms(lambda: fs.launch(xn, c, mask), reps=10)
    bare_ms = no_math_ms(lambda: fs.launch(xn, c, mask), reps=50)
    plain_ms = time_ms(lambda: fs.fused_score_vector_ref(xn, c, mask), reps=3, warmup=1)
    live = int(mask.sum())
    bytes_moved = 4 * (live * n + live * live + live) + p  # x, c, S once; mask
    bound, t_bytes, t_fp32, t_sfu = sweep_bound_ms(live * (live - 1) / 2 * n, live * n,
                                                   bytes_moved)
    tiles = measure.live_tiles(mask[None], 8)
    swept, padded = measure.sweep_chunks(mask[None], None, n, 8)
    say("kernel_time", p=p, n=n, block=8, kernel_ms=f"{ms:.4f}",
        wrapper_ms=f"{wrapper_ms:.4f}", tiles_device_ms=f"{tiles_ms:.4f}",
        queued_event_ms=f"{queued_ms:.4f}", no_math_kernel_ms=f"{bare_ms:.4f}",
        plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.4f}", bytes_bound_ms=f"{t_bytes:.5f}",
        fp32_bound_ms=f"{t_fp32:.4f}", sfu_bound_ms=f"{t_sfu:.4f}",
        kernel_fraction_of_bound=f"{bound / ms:.3f}",
        tiles_skipped=f"{tiles.numel() - int(tiles.sum())}/{tiles.numel()}",
        chunks_swept=f"{swept}/{padded}", gpu=f"'{gpu}'")
    return launches, max(errs), ms, plain_ms, bound, wrapper_ms

SERVE_CFG = LingamServeConfig(max_batch=8)


def ecoli_requests():
    """8 ragged E. coli-size SEM datasets (p 70-85, n 8193-10000: all in the
    (128, 16384) bucket)."""
    rng = np.random.default_rng(13)
    shapes = [(int(rng.integers(70, 86)), int(rng.integers(8193, 10_001)))
              for _ in range(8)]
    return [sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=100 + i))["x"]
            for i, (p, n) in enumerate(shapes)]


def ijr_requests():
    """2 iJR904-size SEM datasets: the slice of bench_table2.py and a ragged one."""
    return [sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=seed))["x"]
            for p, n, seed in ((512, 2000, 1), (480, 1950, 3))]


def bucket_inputs(raw, bucket, dev, dead=torch.nan):
    """The batched kernels' inputs for ``raw`` datasets packed into a bucket:
    rows normalized on the card with each dataset's valid count, and dead
    rows holding ``dead`` in xn and c (NaN: the fused kernel must never read
    them; 0: what the pipeline gives the square kernel)."""
    xs, mask, nv, _ = pack_bucket(raw, *bucket)
    x, mk, n_valid = (torch.from_numpy(a).to(dev) for a in (xs, mask, nv))
    xn = torch.where(mk[..., None], normalize(x, n_valid=n_valid), 0.0)
    c = cov_matrix(xn, n_valid=n_valid)
    xn = torch.where(mk[..., None], xn, dead).contiguous()
    c = torch.where(mk[:, :, None] & mk[:, None, :], c, dead).contiguous()
    return xn, c, mk, n_valid


def phase_batch_kernel(dev, gpu):
    """(a) The batched kernel against its batched plain version. Returns
    (max_abs_err, kernel ms, wrapper ms, plain ms, bound ms, padded bound ms,
    the timed case's shape)."""
    gauss = gauss_data(500, 1900, 4)
    cases = (("ecoli_b8", ecoli_requests(), ECOLI_BUCKET),
             ("ijr904_b2", [ijr_requests()[0], gauss], IJR_BUCKET))
    errs, timing = [], None
    for name, raw, bucket in cases:
        xb, cb, mb, nv = bucket_inputs(raw, bucket, dev)
        s_k = fs.fused_score_batch(xb, cb, mb, n_valid=nv)
        s_r = fs.fused_score_batch_ref(xb, cb, mb, n_valid=nv)
        torch.cuda.synchronize()
        for i in range(len(raw)):
            errs.append(hold(f"{name}[{i}]", s_k[i], s_r[i], xb[i], cb[i], mb[i], nv[i]))
        # Row i of a batched launch is bit-identical to the one-dataset
        # wrapper on dataset i (the prologue is in the kernels), and
        # repeated launches agree.
        rows = [torch.equal(s_k[i], fs.fused_score_vector(xb[i], cb[i], mb[i], n_valid=nv[i]))
                for i in range(len(raw))]
        repeat = torch.equal(fs.fused_score_batch(xb, cb, mb, n_valid=nv), s_k)
        say("batch_row_invariance", case=name, B=len(raw),
            rows_bit_identical=f"{sum(rows)}/{len(rows)}", repeat_bit_identical=repeat)
        check(all(rows), f"{name}: a batched row differs from its one-dataset launch")
        check(repeat, f"{name}: two launches on the same inputs differ")
        if timing is None:
            bsz, _, n_pad = xb.shape
            nv32 = nv.to(torch.int32)
            ms = time_ms(lambda: fs.launch_batch(xb, cb, mb, nv32), reps=20)
            wrapper_ms = time_ms(lambda: fs.fused_score_batch(xb, cb, mb, n_valid=nv), reps=20)
            tiles_ms = device_ms(lambda: fs.launch_batch(xb, cb, mb, nv32), "fused_tri_tiles",
                                 reps=10)
            bare_ms = no_math_ms(lambda: fs.launch_batch(xb, cb, mb, nv32), reps=20)
            plain_ms = time_ms(lambda: fs.fused_score_batch_ref(xb, cb, mb, n_valid=nv),
                               reps=2, warmup=1)
            # What these inputs need: every live pair and live row of each
            # dataset over its valid samples, at the SASS-counted
            # instructions and MUFU per element; the live data read once.
            live_p, nvd = mb.sum(dim=1).double(), nv.double()
            bytes_moved = float((4 * (live_p * nvd + live_p * live_p + live_p)).sum())
            bound, t_bytes, t_fp32, t_sfu = sweep_bound_ms(
                float((live_p * (live_p - 1) / 2 * nvd).sum()), float((live_p * nvd).sum()),
                bytes_moved)
            p_pad = xb.shape[1]
            padded = sweep_bound_ms(bsz * p_pad * (p_pad - 1) / 2 * n_pad, bsz * p_pad * n_pad,
                                    0.0)[0]
            tiles = measure.live_tiles(mb, 8)
            swept, all_chunks = measure.sweep_chunks(mb, nv, n_pad, 8)
            say("batch_kernel_time", case=name, B=bsz, bucket=f"{tuple(xb.shape[1:])}",
                kernel_ms=f"{ms:.4f}", wrapper_ms=f"{wrapper_ms:.4f}",
                tiles_device_ms=f"{tiles_ms:.4f}", no_math_kernel_ms=f"{bare_ms:.4f}",
                plain_ms=f"{plain_ms:.3f}",
                bound_ms=f"{bound:.4f}", bytes_bound_ms=f"{t_bytes:.5f}",
                fp32_bound_ms=f"{t_fp32:.4f}", sfu_bound_ms=f"{t_sfu:.4f}",
                bound_ms_padded_buffer=f"{padded:.4f}",
                kernel_fraction_of_bound=f"{bound / ms:.3f}",
                tiles_skipped=f"{tiles.numel() - int(tiles.sum())}/{tiles.numel()}",
                chunks_swept=f"{swept}/{all_chunks}", gpu=f"'{gpu}'")
            live_p, live_n = live_p.long(), nv.long()
            shape = (f"B={bsz},bucket={xb.shape[1]}x{n_pad},"
                     f"p={int(live_p.min())}-{int(live_p.max())},"
                     f"n={int(live_n.min())}-{int(live_n.max())},block=8")
            timing = (ms, wrapper_ms, plain_ms, bound, padded, shape)
            stage_times(name, raw, bucket, dev, gpu)
    return (max(errs), *timing)


def stage_times(name, raw, bucket, dev, gpu):
    """The fused wrapper's mean time per call at each stage size m of one
    ``fit_batch`` dispatch of ``raw`` in ``bucket``, on the inputs that
    dispatch gave it: every call of the stage once per repetition."""
    xs, mask, nv, _ = pack_bucket(raw, *bucket)
    calls, orig = {}, ops.score_batch

    def spy(x, c, m, **kw):
        calls.setdefault(x.shape[1], []).append(
            (x.clone(), c.clone(), m.clone(),
             {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()}))
        return orig(x, c, m, **kw)

    ops.score_batch = spy
    try:
        fit_batch(xs, ParaLiNGAMConfig(score_backend="hopper_fused"), n_valid=nv, mask=mask,
                  device=dev)
    finally:
        ops.score_batch = orig
    for m, group in sorted(calls.items(), reverse=True):
        def run(group=group):
            for x, c, mk, kw in group:
                fs.fused_score_batch(x, c, mk, **kw)
        ms = time_ms(run, reps=3, warmup=1) / len(group)
        say("batch_stage_time", case=name, m=m, calls=len(group), wrapper_ms=f"{ms:.4f}",
            stage_ms=f"{ms * len(group):.3f}", gpu=f"'{gpu}'")


def phase_fit_batch(dev, gpu):
    """(b) ``fit_batch`` on the E. coli bucket with the kernel and with the
    plain square path. Returns each request's order, and the kernel's
    results on the bucket and on the iJR904 bucket with their seconds
    (``{"ecoli_dense": (arrays, s), "ijr_dense": ...}``: the one-rank side of
    ``[fit_batch_data_sharded]``)."""
    raw = ecoli_requests()
    xs, mask, nv, _ = pack_bucket(raw, *ECOLI_BUCKET)
    runs = {}
    for backend in ("hopper_fused", "torch"):
        fs.BATCH_LAUNCHES = cu.RANK1_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit_batch(xs, ParaLiNGAMConfig(score_backend=backend), n_valid=nv,
                        mask=mask, device=dev)
        orders = res.orders.cpu().numpy()
        torch.cuda.synchronize()
        runs[backend] = (res, orders, time.perf_counter() - t0, fs.BATCH_LAUNCHES,
                         cu.RANK1_LAUNCHES)
    (rk, ok_, tk, launches, updates), (rp, op_, tp_, _, plain_updates) = (
        runs["hopper_fused"], runs["torch"])
    p_live = [x.shape[0] for x in raw]
    same = [list(ok_[i, :p]) == list(op_[i, :p]) for i, p in enumerate(p_live)]
    b_err = (rk.b - rp.b).abs().max().item()
    nv_err = ((rk.noise_var - rp.noise_var).abs() / rp.noise_var.abs().clamp(min=1e-30)).max().item()
    finite = bool(torch.isfinite(rk.b).all() and torch.isfinite(rk.noise_var).all())
    say("fit_batch_ecoli", B=len(raw), bucket=f"{ECOLI_BUCKET}", orders_equal=f"{sum(same)}/{len(same)}",
        b_max_abs_diff=b_err, noise_var_max_rel_diff=nv_err, launches=launches,
        find_roots=ECOLI_BUCKET[0] - 1, update_launches=updates,
        update_launches_torch=plain_updates, fit_batch_s_hopper_fused=f"{tk:.4f}",
        fit_batch_s_torch=f"{tp_:.4f}", gpu=f"'{gpu}'")
    check(all(same), "hopper_fused and torch orders differ in the E. coli bucket")
    check(b_err <= 1e-6 and nv_err <= 1e-6, "B or noise_var differ between the backends")
    check(launches == ECOLI_BUCKET[0] - 1,
          f"{launches} batched launches for {ECOLI_BUCKET[0] - 1} find-roots")
    check(updates == ECOLI_BUCKET[0] - 1 and plain_updates == 0,
          f"{updates} update launches for {ECOLI_BUCKET[0] - 1} iterations "
          f"({plain_updates} on torch)")
    check(finite, "non-finite B or noise variances in the E. coli bucket")
    # Each dataset's order, B and noise variances equal, bit for bit, those
    # of its own one-dataset fit_batch on the same padded inputs.
    differ = batch_differences(rk, xs, mask, nv, ParaLiNGAMConfig(score_backend="hopper_fused"),
                               p_live, ("orders",), dev)
    say("fit_batch_rows", B=len(raw), equal_to_own_fit_batch=f"{len(raw) - len({d.split(':')[0] for d in differ})}/{len(raw)}",
        first_differences=",".join(differ) or "none")
    check(not differ, "a dataset's fit differs between its batch and its own")
    ijr = ijr_requests()
    xi, mi, nvi, _ = pack_bucket(ijr, *IJR_BUCKET)
    ri, ti = timed(lambda: batch_arrays(fit_batch(
        xi, ParaLiNGAMConfig(score_backend="hopper_fused"), n_valid=nvi, mask=mi, device=dev)))
    want = {"ecoli_dense": (batch_arrays(rk), tk), "ijr_dense": (ri, ti)}
    return [list(ok_[i, :p]) for i, p in enumerate(p_live)], want


def batch_differences(res, xs, mask, nv, cfg, p_live, names, dev):
    """Where each dataset's results in the batched ``res`` differ from its
    own one-dataset ``fit_batch`` on the same padded inputs: the per-
    iteration ``names`` (first differing iteration), then B and the noise
    variances on its live rows, bit for bit. Returns "i:field@index" items."""
    got = {k: getattr(res, k).cpu().numpy() for k in names}
    b, omega = res.b.cpu().numpy(), res.noise_var.cpu().numpy()
    differ = []
    for i, p in enumerate(p_live):
        one = fit_batch(xs[i:i + 1], cfg, n_valid=nv[i:i + 1], mask=mask[i:i + 1], device=dev)
        want = {k: getattr(one, k).cpu().numpy()[0] for k in names}
        differ += [f"{i}:{k}@{int(np.flatnonzero(got[k][i, :p] != want[k][:p])[0])}"
                   for k in names if list(got[k][i, :p]) != list(want[k][:p])]
        b1, om1 = one.b.cpu().numpy()[0], one.noise_var.cpu().numpy()[0]
        if not np.array_equal(b[i, :p, :p], b1[:p, :p]):
            differ.append(f"{i}:b@{float(np.abs(b[i, :p, :p] - b1[:p, :p]).max()):.3e}")
        if not np.array_equal(omega[i, :p], om1[:p]):
            differ.append(f"{i}:noise_var@{float(np.abs(omega[i, :p] / om1[:p] - 1).max()):.3e}")
    return differ


def conserved(st) -> bool:
    return (st["submitted"] == st["admitted"] + st["shed"] + st["rejected"] + st["quarantined"]
            and st["admitted"] == st["delivered"] + st["timeouts"] + st["failed"]
            + st["queue_depth"] + st["in_flight"])


def serve_round(eng, requests, threads=3):
    """Submit ``requests`` from ``threads`` submitter threads; wait for every
    ticket. Returns (results, wall seconds)."""
    tickets, errors = [None] * len(requests), []

    def submitter(w):
        try:
            for i in range(w, len(requests), threads):
                tickets[i] = eng.submit(requests[i])
        except Exception as e:  # noqa: BLE001 — reported through `errors`
            errors.append(repr(e))

    t0 = time.perf_counter()
    pool = [threading.Thread(target=submitter, args=(w,)) for w in range(threads)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(600)
    check(not errors and all(not th.is_alive() for th in pool), f"submit failed: {errors}")
    results = [t.result(600) for t in tickets]
    return results, time.perf_counter() - t0


def reset_counts():
    """Every kernel wrapper's launch count to 0."""
    fs.LAUNCHES = fs.BATCH_LAUNCHES = ps.LAUNCHES = ps.BATCH_LAUNCHES = 0
    cu.DATA_LAUNCHES = cu.COV_LAUNCHES = cu.RANK1_LAUNCHES = cu.RING_LAUNCHES = 0
    sd.LAUNCHES = 0


def counts() -> dict:
    return {"fused_score": fs.LAUNCHES, "fused_score_batch": fs.BATCH_LAUNCHES,
            "pairwise_moments": ps.LAUNCHES, "pairwise_moments_batch": ps.BATCH_LAUNCHES,
            "update_data": cu.DATA_LAUNCHES, "update_cov": cu.COV_LAUNCHES,
            "rank1_update": cu.RANK1_LAUNCHES, "ring_update": cu.RING_LAUNCHES,
            "ssd_decode": sd.LAUNCHES}


def engine_round(cfg, requests, dev, *, replicas=1, prewarm=None, profile=False):
    """Serve ``requests`` once through an ``AsyncLingamEngine`` whose
    dispatch seam records every dispatch. Returns (results, wall seconds,
    stats, the served dispatch records, prewarm seconds, kernel launches of
    the served round, profiler rows of a second round or None)."""
    records, mu, holder = [], threading.Lock(), {}

    def recording(bucket, payloads):
        t0 = time.perf_counter()
        out = holder["eng"]._device_dispatch(bucket, payloads)
        with mu:
            records.append((bucket, list(payloads), out, time.perf_counter() - t0))
        return out

    # A bucket flushes when it holds 8 requests, or 1 s after its oldest one
    # arrived: the submitters validate each dataset first (~0.1 s each).
    t0 = time.perf_counter()
    eng = AsyncLingamEngine(
        cfg, SERVE_CFG, batch_cfg=BatchingConfig(max_batch=8, max_queue=64, flush_interval=1.0),
        dispatch=recording, replicas=replicas, prewarm=prewarm, device=dev)
    holder["eng"] = eng
    prewarm_s = time.perf_counter() - t0
    try:
        reset_counts()
        paralingam.reset_dispatch_stats()
        results, wall = serve_round(eng, requests)  # the main path
        launches = counts()
        st = eng.stats()
        st["rank1_update"] = paralingam.dispatch_stats_snapshot()["rank1_update"]
        busy = None
        if profile:
            from torch.profiler import ProfilerActivity, profile as prof_ctx

            with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, wall2 = serve_round(eng, requests)
            busy = (device_rows(prof), wall2)
    finally:
        eng.close(timeout=120)
    check(all(r is not None for r in results), "a ticket did not resolve")
    check(conserved(st), f"stats ledger does not balance: {st}")
    check(st["delivered"] == len(requests), f"{st['delivered']} of {len(requests)} delivered")
    check(st["kernel_bypass"] == 0, f"kernel_bypass={st['kernel_bypass']}")
    return results, wall, st, records[:st["dispatches"]], prewarm_s, launches, busy


def replay_identical(served, cfg, dev) -> int:
    """How many served results are bit-identical to a replay of their
    recorded dispatch through ``fit_batch``."""
    ok = 0
    for bucket, payloads, out, _ in served:
        xs, mask, nv, exact = pack_bucket(payloads, *bucket,
                                          dtype=paralingam.numpy_dtype(cfg.dtype))
        seams = {} if exact else dict(n_valid=nv, mask=mask)
        res = fit_batch(xs, cfg, device=dev, **seams)
        orders, b, omega = res.orders.cpu().numpy(), res.b.cpu().numpy(), res.noise_var.cpu().numpy()
        comps, rounds = res.comparisons.cpu().numpy(), res.rounds.cpu().numpy()
        for i, (x, f) in enumerate(zip(payloads, out)):
            p = x.shape[0]
            ok += (list(orders[i, :p]) == f.order and np.array_equal(b[i, :p, :p], f.b)
                   and np.array_equal(omega[i, :p], f.noise_var)
                   and int(comps[i, :p - 1].sum()) == f.comparisons
                   and int(rounds[i, :p - 1].sum()) == f.rounds)
    return ok


def phase_engine(dev, gpu, batch_orders, profile: bool):
    """(c) The serving path on the card. Returns the batched kernel's and
    the update kernel's launches in the served run, and the served fits
    (the one-rank side of ``[engine_data_sharded]``)."""
    ecoli, ijr = ecoli_requests(), ijr_requests()
    requests = ecoli + ijr
    cfg = ParaLiNGAMConfig()
    results, wall, st, served, prewarm_s, launched, busy = engine_round(
        cfg, requests, dev, replicas=2, prewarm=[(85, 10_000), (512, 2000)], profile=profile)
    launches, vec_launches = launched["fused_score_batch"], launched["fused_score"]
    updates = launched["rank1_update"]
    dispatch_s = [f"{r[0]}x{len(r[1])}:{r[3]:.4f}" for r in served]
    say("engine", requests=len(requests), dispatches=st["dispatches"], prewarm_s=f"{prewarm_s:.2f}",
        prewarm_buckets=st["prewarm"]["buckets"], wall_s=f"{wall:.4f}",
        requests_per_s=f"{len(requests) / wall:.3f}", seconds_per_dispatch=",".join(dispatch_s),
        launches=launches, update_launches=updates,
        dispatch_stats_rank1_update=st["rank1_update"], kernel_bypass=st["kernel_bypass"],
        gpu=f"'{gpu}'")
    check(st["auto_downgrade"] == 0, f"auto_downgrade={st['auto_downgrade']}")
    want = sum(r[0][0] - 1 for r in served)
    check(launches == want and vec_launches == 0,
          f"{launches} batched launches (want {want}), {vec_launches} one-dataset launches")
    check(updates == want == st["rank1_update"],
          f"{updates} update launches, {st['rank1_update']} counted by dispatch_stats "
          f"(want {want})")

    # Each result is bit-identical to a replay of its recorded dispatch.
    replay_ok = replay_identical(served, cfg, dev)
    say("engine_replay", results_bit_identical_to_replay=f"{replay_ok}/{len(requests)}")
    check(replay_ok == len(requests), "a served result differs from the replay of its dispatch")
    same_as_b = sum(res.order == o for res, o in zip(results[:len(ecoli)], batch_orders))
    say("engine_vs_fit_batch", ecoli_orders_equal_to_phase_b=f"{same_as_b}/{len(ecoli)}",
        held=False)
    for res in results:
        check(np.isfinite(res.b).all() and np.isfinite(res.noise_var).all(),
              "non-finite B or noise variances served")

    # One fit per request, for comparison: the whole round, and the E. coli
    # requests against the seconds of their bucket's dispatches.
    serial = []
    for x in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(x, cfg, device=dev)
        torch.cuda.synchronize()
        serial.append(time.perf_counter() - t0)
    serial_ecoli = sum(serial[:len(ecoli)])
    ecoli_s = sum(r[3] for r in served if r[0] == ECOLI_BUCKET)
    say("engine_vs_serial_fit", requests=len(requests), serial_fit_s=f"{sum(serial):.4f}",
        serial_requests_per_s=f"{len(requests) / sum(serial):.3f}",
        engine_requests_per_s=f"{len(requests) / wall:.3f}",
        ecoli_serial_fit_s=f"{serial_ecoli:.4f}",
        ecoli_serial_requests_per_s=f"{len(ecoli) / serial_ecoli:.3f}",
        ecoli_dispatch_s=f"{ecoli_s:.4f}",
        ecoli_batched_requests_per_s=f"{len(ecoli) / ecoli_s:.3f}",
        ecoli_speedup=f"{serial_ecoli / ecoli_s:.2f}", gpu=f"'{gpu}'")
    if busy is not None:
        rows, wall2 = busy
        busy_us = sum(r[0] for r in rows)
        say("profile_engine", requests=len(requests), wall_s=f"{wall2:.4f}",
            device_busy_s=f"{busy_us / 1e6:.4f}", device_busy_share=f"{busy_us / 1e6 / wall2:.3f}",
            gpu=f"'{gpu}'")
        say_rows("engine", rows, busy_us)
    return launches, updates, results


def device_rows(prof):
    """(device us, kernel name, calls) of a torch.profiler run, largest first."""
    from torch.autograd import DeviceType

    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted((r for r in rows if r[0] > 0), reverse=True)


def say_rows(run, rows, busy_us, top=12):
    for us, key, count in rows[:top]:
        say("profile_kernel", run=run, share=f"{us / busy_us:.3f}", device_ms=f"{us / 1e3:.3f}",
            calls=count, name=f"'{key[:90]}'")


def scan_bucket(xb, cb, mb, nv, kernel_update: bool):
    """The dense scan over a bucket with the update kernel, or with the
    plain updates in its place (the parent's path)."""
    saved = paralingam.UPDATE_KERNEL_BACKENDS
    paralingam.UPDATE_KERNEL_BACKENDS = saved if kernel_update else ()
    try:
        return paralingam._scan_order_impl(xb, cb, mask0=mb, n_valid=nv, backend="hopper_fused")
    finally:
        paralingam.UPDATE_KERNEL_BACKENDS = saved


def profile_find_root(dev, gpu):
    """``--profile``: the torch ops and device kernels of one dense find-root
    of the E. coli bucket's first stage, and of ``fused_layout``, the plain
    version's torch prologue (row entropies, diagonal tiles, padded layout),
    whose work the kernels now do themselves; then of that bucket's first
    update, plain (``covariance.update_data`` + ``update_cov``) and through
    the update kernel, and of its whole dense scan with each, per
    iteration."""
    xb, cb, mb, nv = bucket_inputs(ecoli_requests(), ECOLI_BUCKET, dev, dead=0.0)
    roots = paralingam._find_root_dense_impl(xb, cb, mb, 32, "hopper_fused", n_valid=nv)[0]
    # A session may drop device events, never add them: the fullest of five
    # one-call sessions is the count. Once other sessions have run in the
    # process, short ones were seen to lose all of them (a fresh process
    # counts them whole), so main() runs this before any other session.
    counted = {}
    for what, fn in (
            ("find_root", lambda: paralingam._find_root_dense_impl(
                xb, cb, mb, 32, "hopper_fused", n_valid=nv)),
            ("torch_prologue", lambda: fused_layout(xb, cb, mb, 8, n_valid=nv)),
            ("update_plain", lambda: cu.rank1_update_ref(xb, cb, roots, mb, n_valid=nv)),
            ("update_kernel", lambda: ops.rank1_update(xb, cb, roots, mb, nv)),
            ("scan_plain_update", lambda: scan_bucket(xb, cb, mb, nv, False)),
            ("scan_kernel_update", lambda: scan_bucket(xb, cb, mb, nv, True))):
        fn()
        torch.cuda.synchronize()
        for _ in range(5 if what in ("find_root", "torch_prologue") else 2):
            rows, events = profiled_rows(fn, 1, with_events=True)
            seen = (sum(e.count for e in events if e.key.startswith("aten::")),
                    sum(r[2] for r in rows), rows)
            counted[what] = max(counted.get(what, seen), seen, key=lambda c: c[1])
    (fr_ops, kernels, rows), (p_ops, p_kernels, _) = counted["find_root"], counted["torch_prologue"]
    names = ",".join(
        f"{r[1].replace('(anonymous namespace)::', '').split('(')[0].split('<')[0].split('::')[-1]}"
        f":{r[2]}" for r in rows)
    say("profile_find_root", B=xb.shape[0], bucket=f"{tuple(xb.shape[1:])}",
        aten_ops=fr_ops, device_kernels=kernels, kernels=names,
        torch_prologue_aten_ops=p_ops, torch_prologue_device_kernels=p_kernels,
        gpu=f"'{gpu}'")
    its = ECOLI_BUCKET[0] - 1
    (u_ops, u_kernels, _), (k_ops, k_kernels, _) = counted["update_plain"], counted["update_kernel"]
    (sp_ops, sp_kernels, _), (sk_ops, sk_kernels, _) = (counted["scan_plain_update"],
                                                        counted["scan_kernel_update"])
    say("profile_scan_iteration", B=xb.shape[0], bucket=f"{tuple(xb.shape[1:])}", iterations=its,
        update_aten_ops_plain=u_ops, update_device_kernels_plain=u_kernels,
        update_aten_ops_kernel=k_ops, update_device_kernels_kernel=k_kernels,
        aten_ops_per_iteration_plain_update=f"{sp_ops / its:.1f}",
        aten_ops_per_iteration_kernel_update=f"{sk_ops / its:.1f}",
        device_kernels_per_iteration_plain_update=f"{sp_kernels / its:.1f}",
        device_kernels_per_iteration_kernel_update=f"{sk_kernels / its:.1f}", gpu=f"'{gpu}'")


def profile_fits(dev, gpu):
    """``--profile``: where the time of one fit goes, from torch.profiler —
    device time by kernel, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    for p, n, seed in ((85, 10_000, 0), (512, 2000, 1)):
        x = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=seed))["x"]
        run_fit(x, "hopper_fused", dev)  # warm-up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, _, wall, _, _ = run_fit(x, "hopper_fused", dev)
        rows = device_rows(prof)
        busy_us = sum(r[0] for r in rows)
        say("profile", p=p, n=n, wall_s=f"{wall:.4f}", device_busy_s=f"{busy_us / 1e6:.4f}",
            device_busy_share=f"{busy_us / 1e6 / wall:.3f}", gpu=f"'{gpu}'")
        say_rows(f"fit_p{p}", rows, busy_us)
    # The threshold fit of examples/causal_discovery_ecoli.py.
    x = sem.generate(sem.SemSpec(p=85, n=10_000, density="sparse", seed=7))["x"]
    cfg = ParaLiNGAMConfig(threshold=True, chunk=16)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: fit(x, cfg, device=dev))
    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    say("profile", run="threshold_fit_p85", wall_s=f"{wall:.4f}",
        device_busy_s=f"{busy_us / 1e6:.4f}", device_busy_share=f"{busy_us / 1e6 / wall:.3f}",
        gpu=f"'{gpu}'")
    say_rows("threshold_fit_p85", rows, busy_us)
    # One dispatch of the E. coli bucket (B=8), as the engine runs it.
    xs, mask, nv, _ = pack_bucket(ecoli_requests(), *ECOLI_BUCKET)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit_batch(xs, ParaLiNGAMConfig(), n_valid=nv, mask=mask, device=dev).orders.cpu()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    say("profile", run="fit_batch_ecoli_b8", wall_s=f"{wall:.4f}",
        device_busy_s=f"{busy_us / 1e6:.4f}", device_busy_share=f"{busy_us / 1e6 / wall:.3f}",
        gpu=f"'{gpu}'")
    say_rows("fit_batch_ecoli_b8", rows, busy_us)


# -- slice 3: the square moments kernel, the host driver, the threshold machine

SQUARE_SOURCE = "src/repro_torch/kernels/csrc/pairwise_moments.cu"
SQUARE_REPLACES = "src/repro/kernels/pairwise_score.py:46"
# Entropies after the epilogue, kernel against plain: the rtol/atol of
# tests/test_kernel_moments.py (the JAX package's kernel route).
H_RTOL = H_ATOL = 1e-5


def live_off_diagonal(mask_i, mask_j=None):
    """(pi, pj) pairs of live rows with i != j: the sums that reach a score.
    The (i, i) sums are rounding noise amplified by up to 1e6 (c_ii ~ 1), and
    so are those of a row against its copies in a compacted buffer's dead
    slots."""
    mask_j = mask_i if mask_j is None else mask_j
    pi, pj = mask_i.shape[0], mask_j.shape[0]
    eye = torch.arange(pi, device=mask_i.device)[:, None] == torch.arange(pj, device=mask_i.device)
    return mask_i[:, None] & mask_j[None, :] & ~eye


def hold_sums(name, xi, xj, c, sel, live_i=None, live_j=None, n_valid=None):
    """The square kernel against its plain version on one dataset, called as
    the pipeline calls it (live rows, valid count): the raw sums on the
    ``sel`` entries within ``sum_tolerance``, every pair with a dead row
    exactly 0, and the entropies after ``finalize_moments`` within
    H_RTOL/H_ATOL. Returns the max abs error of the sums."""
    kw = {"live_i": live_i, "live_j": live_j, "n_valid": n_valid}
    k1, k2 = ps.pairwise_moments(xi, xj, c, **kw)
    r1, r2 = ps.pairwise_moments_ref(xi, xj, c, **kw)
    torch.cuda.synchronize()
    tol = ps.sum_tolerance(xi, xj, c, n_valid)[sel].double()
    errs, ratios = [], []
    for k, r in ((k1, r1), (k2, r2)):
        check(bool(torch.all(torch.isfinite(k[sel]))), f"{name}: non-finite sums")
        e = (k[sel].double() - r[sel].double()).abs()
        errs.append(e.max().item())
        ratios.append((e / tol).max().item())
    ones = torch.ones(max(xi.shape[0], xj.shape[0]), dtype=torch.bool, device=xi.device)
    li = ones[:xi.shape[0]] if live_i is None else live_i
    lj = ones[:xj.shape[0]] if live_j is None else live_j
    dead = ~(li[:, None] & lj[None, :])
    zero = bool(torch.all(k1[dead] == 0) and torch.all(k2[dead] == 0))
    n = xi.shape[-1]
    hk = ps.finalize(k1, k2, n, n_valid)[sel].double()
    hr = ps.finalize(r1, r2, n, n_valid)[sel].double()
    h_ok = bool(torch.all((hk - hr).abs() <= H_ATOL + H_RTOL * hr.abs()))
    ok = max(ratios) <= 1.0 and h_ok and zero
    say("pairwise_vs_plain", case=name, pi=xi.shape[0], pj=xj.shape[0], n=n,
        n_valid="n" if n_valid is None else int(n_valid), held_entries=int(sel.sum()),
        dead_pairs=int(dead.sum()), dead_pairs_zero=zero, max_abs_m1=f"{errs[0]:.3e}",
        max_abs_m2=f"{errs[1]:.3e}", max_err_over_tol=f"{max(ratios):.3e}",
        max_rel_entropy=f"{((hk - hr).abs() / hr.abs().clamp(min=1e-30)).max().item():.3e}",
        entropies_ok=h_ok, ok=ok)
    check(ok, f"{name}: square kernel disagrees with plain")
    return max(errs)


def square_bound_ms(pair_samples: float, bytes_moved: float):
    """(bound, bound_by, FP32 ms, SFU ms) of the square sums on this much
    work: the (ordered pair, sample) elements that a score needs (live
    off-diagonal pairs over valid samples), each counted at one direction of
    the fused sweep's math, half its FP32 and MUFU instructions per
    (unordered pair, sample) from this run's ``[fused_sass]``, whatever
    implements it; or the bytes read and written once over HBM."""
    tf, tm = SWEEP_SASS["tiles"]
    t = {"bytes": bytes_moved / HBM_BPS, "fp32": tf / 2 * pair_samples / FP32_INSNS,
         "sfu": tm / 2 * pair_samples / SFU_OPS}
    key = max(t, key=t.get)
    return (t[key] * 1e3, "bytes" if key == "bytes" else "operations",
            t["fp32"] * 1e3, t["sfu"] * 1e3)


def square_bytes(live, n_valid, m):
    """Bytes the square sums must move: the live rows' valid samples and
    their correlations read once, the two (m, m) sums written once."""
    return 4 * (live * n_valid + live * live + 2 * m * m)


def capture_dense_inputs(x, backend, dev):
    """Fit once and keep the find-root inputs of the first iteration of every
    stage (rows, correlations, mask), keyed by the stage's buffer size."""
    captured, orig = {}, paralingam._find_root_dense_impl

    def spy(xb, cb, mask, **kw):
        if xb.shape[1] not in captured:
            captured[xb.shape[1]] = (xb[0].clone(), cb[0].clone(), mask[0].clone())
        return orig(xb, cb, mask, **kw)

    paralingam._find_root_dense_impl = spy
    try:
        fit(x, ParaLiNGAMConfig(score_backend=backend), device=dev)
    finally:
        paralingam._find_root_dense_impl = orig
    return captured


def masked_case(p, n, n_pad, seed, dev, fill=0.0):
    """Normalized Gaussian rows with every fifth row dead, held at 0 in xn
    and c as the pipeline holds them, zero-padded to ``n_pad`` samples (the
    padding filled with ``fill``): (unpadded rows, padded rows, c, mask)."""
    xn, c = normalized(gauss_data(p, n, seed), dev)
    mask = torch.arange(p, device=dev) % 5 != 2
    xn = torch.where(mask[:, None], xn, 0.0).contiguous()
    c = torch.where(mask[:, None] & mask[None, :], c, 0.0).contiguous()
    xp = torch.full((p, n_pad), fill, device=dev)
    xp[:, :n] = xn
    return xn, xp, c, mask


def phase_pairwise_kernel(dev, gpu, ecoli_x):
    """The square moments kernel against its plain version, called as the
    pipeline calls it: ragged edges, live-row masks and valid counts on
    padded buffers, the E. coli fit's first stage (m=128, n=10000) under the
    fit's mask, m=512 n=2000, padding exactness, batch-row identity at the
    (128, 16384) bucket under masks and valid counts, and times."""
    errs, timing = [], {}
    xn, c = normalized(np.random.default_rng(1).standard_normal((13, 700)), dev)
    full = torch.ones(13, dtype=torch.bool, device=dev)
    errs.append(hold_sums("ragged_p13_n700", xn, xn, c, live_off_diagonal(full)))
    xi, cj = xn[:, :].contiguous(), c[:, :5].contiguous()
    errs.append(hold_sums("block_13x5_n700", xi, xn[:5].contiguous(), cj,
                          live_off_diagonal(full, full[:5])))
    # Masks and a valid count, as the pipeline passes them: dead rows 0,
    # samples past n_valid 0.
    xm, xp, cm, mm = masked_case(37, 1300, 2048, 4, dev)
    nv = torch.tensor(1300, device=dev)
    errs.append(hold_sums("masked_p37_n1300_pad2048", xp, xp, cm, live_off_diagonal(mm),
                          live_i=mm, live_j=mm, n_valid=nv))
    errs.append(hold_sums("masked_block_37x21_n1300_pad2048", xp, xp[:21].contiguous(),
                          cm[:, :21].contiguous(), live_off_diagonal(mm, mm[:21]),
                          live_i=mm, live_j=mm[:21].contiguous(), n_valid=nv))
    # zero columns add exactly 0: bit-identical sums
    same = []
    for n_pad in (1024, 2048):
        xz = torch.zeros((13, n_pad), device=dev)
        xz[:, :700] = xn
        same += [torch.equal(a, b) for a, b in zip(ps.pairwise_moments(xn, xn, c),
                                                    ps.pairwise_moments(xz, xz, c))]
    # under n_valid the loops stop at the valid count: a padded launch gives
    # the unpadded launch's bits, whatever the padding holds (n=700 rows
    # 16-byte aligned, n=1901 rows not: the 4-byte staging path)
    padded = []
    for p, n, n_pad, seed in ((21, 700, 1024, 2), (19, 1901, 2048, 3)):
        for fill in (0.0, torch.nan):
            xm, xp, cm, mm = masked_case(p, n, n_pad, seed, dev, fill)
            kw = {"live_i": mm, "live_j": mm}
            padded += [torch.equal(a, b) for a, b in zip(
                ps.pairwise_moments(xp, xp, cm, n_valid=torch.tensor(n, device=dev), **kw),
                ps.pairwise_moments(xm, xm, cm, **kw))]
    say("pairwise_padding", sums_bit_identical=f"{sum(same)}/{len(same)}",
        n_valid_padded_vs_unpadded_bit_identical=f"{sum(padded)}/{len(padded)}",
        cases="p21_n700_pad1024,p19_n1901_pad2048;fill=0,nan")
    check(all(same), "zero-padding n changed the square kernel's sums")
    check(all(padded), "a padded launch with n_valid differs from the unpadded launch")

    stages = capture_dense_inputs(ecoli_x, "hopper", dev)
    xe, ce, me = stages[max(stages)]  # the first stage
    errs.append(hold_sums(f"ecoli_fit_stage_m{xe.shape[0]}", xe, xe, ce, live_off_diagonal(me),
                          live_i=me, live_j=me))
    xg, cg = normalized(gauss_data(*SLICE, 1), dev)
    mg = torch.ones(SLICE[0], dtype=torch.bool, device=dev)
    errs.append(hold_sums(f"gauss_m{SLICE[0]}_n{SLICE[1]}", xg, xg, cg, live_off_diagonal(mg),
                          live_i=mg, live_j=mg))

    for name, (x_, c_, m_) in (("ecoli_stage", (xe, ce, me)), ("slice", (xg, cg, mg))):
        m, n = x_.shape
        args = (x_[None], x_[None], c_[None], m_[None], m_[None])
        ms = time_ms(lambda: ps._launch(*args), reps=50)
        unmasked_ms = time_ms(lambda: ps._launch(*args[:3]), reps=20)
        bare_ms = no_math_ms(lambda: ps._launch(*args), reps=20, module=ps)
        wrapper_ms = time_ms(lambda: ps.pairwise_moments(x_, x_, c_, live_i=m_, live_j=m_), reps=20)
        plain_ms = time_ms(lambda: ps.pairwise_moments_ref(x_, x_, c_, live_i=m_, live_j=m_),
                           reps=3, warmup=1)
        live = int(m_.sum())
        bound, by, t_fp32, t_sfu = square_bound_ms(live * (live - 1) * n, square_bytes(live, n, m))
        padded_bound = square_bound_ms(m * m * n, square_bytes(m, n, m))[0]
        lanes = ps._lanes(-(-m // ps.BLOCK_I) * -(-m // ps.BLOCK_J))
        timing[name] = (ms, wrapper_ms, plain_ms, bound, by)
        say("pairwise_kernel_time", shape=f"m{m}_n{n}", live_rows=live, kernel_ms=f"{ms:.4f}",
            wrapper_ms=f"{wrapper_ms:.4f}", unmasked_kernel_ms=f"{unmasked_ms:.4f}",
            no_math_kernel_ms=f"{bare_ms:.4f}", plain_ms=f"{plain_ms:.3f}",
            bound_ms=f"{bound:.4f}", bound_by=by, bound_ms_fp32=f"{t_fp32:.4f}",
            bound_ms_sfu=f"{t_sfu:.4f}", bound_ms_padded_buffer=f"{padded_bound:.4f}",
            kernel_fraction_of_bound=f"{bound / ms:.3f}", lanes=lanes,
            threads_per_block=ps.MICRO_TILES * lanes, blocks_per_sm=ps.occupancy(lanes),
            gpu=f"'{gpu}'")

    # The batched entry on the E. coli bucket, as the pipeline calls it (dead
    # rows 0, each dataset's mask and valid count): per dataset against
    # plain, and row b bit-identical to a one-dataset launch.
    xb, cb, mb, nv = bucket_inputs(ecoli_requests(), ECOLI_BUCKET, dev, dead=0.0)
    bsz, p_pad, n_pad = xb.shape
    nv32 = fs._valid_counts(nv, bsz, dev)
    b1, b2 = ps.pairwise_moments_batch(xb, cb, mask=mb, n_valid=nv)
    r1, r2 = ps.pairwise_moments_batch_ref(xb, cb, mask=mb, n_valid=nv)
    torch.cuda.synchronize()
    rows, ratios, zero = [], [], True
    for b in range(bsz):
        o1, o2 = ps._launch(xb[b:b + 1], xb[b:b + 1], cb[b:b + 1], mb[b:b + 1], mb[b:b + 1],
                            nv32[b:b + 1])
        rows.append(torch.equal(b1[b], o1[0]) and torch.equal(b2[b], o2[0]))
        sel = live_off_diagonal(mb[b])
        dead = ~(mb[b][:, None] & mb[b][None, :])
        zero = zero and bool(torch.all(b1[b][dead] == 0) and torch.all(b2[b][dead] == 0))
        tol = ps.sum_tolerance(xb[b], xb[b], cb[b], nv[b])[sel].double()
        for k, r in ((b1[b], r1[b]), (b2[b], r2[b])):
            e = (k[sel].double() - r[sel].double()).abs()
            errs.append(e.max().item())
            ratios.append((e / tol).max().item())
    say("pairwise_batch", B=bsz, bucket=f"{tuple(xb.shape[1:])}", masked=True, n_valid=True,
        rows_bit_identical=f"{sum(rows)}/{len(rows)}", dead_pairs_zero=zero,
        max_err_over_tol=f"{max(ratios):.3e}")
    check(all(rows), "a batched row of the square kernel differs from its one-dataset launch")
    check(max(ratios) <= 1.0 and zero, "the batched square kernel disagrees with plain")
    ms = time_ms(lambda: ps._launch(xb, xb, cb, mb, mb, nv32), reps=10)
    unmasked_ms = time_ms(lambda: ps._launch(xb, xb, cb), reps=5)
    bare_ms = no_math_ms(lambda: ps._launch(xb, xb, cb, mb, mb, nv32), reps=10, module=ps)
    wrapper_ms = time_ms(lambda: ps.pairwise_moments_batch(xb, cb, mask=mb, n_valid=nv), reps=5)
    plain_ms = time_ms(lambda: ps.pairwise_moments_batch_ref(xb, cb, mask=mb, n_valid=nv),
                       reps=2, warmup=1)
    live, nvd = mb.sum(dim=1).double(), nv.double()
    bound, by, t_fp32, t_sfu = square_bound_ms(float((live * (live - 1) * nvd).sum()),
                                               float(square_bytes(live, nvd, p_pad).sum()))
    padded = square_bound_ms(bsz * p_pad * p_pad * n_pad, bsz * square_bytes(p_pad, n_pad, p_pad))[0]
    timing["batch"] = (ms, wrapper_ms, plain_ms, bound, by, padded,
                       f"B={bsz},bucket={p_pad}x{n_pad},p={int(live.min())}-{int(live.max())},"
                       f"n={int(nv.min())}-{int(nv.max())}")
    say("pairwise_batch_kernel_time", B=bsz, bucket=f"{(p_pad, n_pad)}", kernel_ms=f"{ms:.4f}",
        wrapper_ms=f"{wrapper_ms:.4f}", unmasked_kernel_ms=f"{unmasked_ms:.4f}",
        no_math_kernel_ms=f"{bare_ms:.4f}", plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.4f}",
        bound_by=by, bound_ms_fp32=f"{t_fp32:.4f}", bound_ms_sfu=f"{t_sfu:.4f}",
        bound_ms_padded_buffer=f"{padded:.4f}", kernel_fraction_of_bound=f"{bound / ms:.3f}",
        gpu=f"'{gpu}'")
    return max(errs), timing


def dense_scores_along(x, order, it, dev, dtype=torch.float32):
    """The dense scores (plain square path, in float32) and their tolerance
    at iteration ``it`` of the updates along ``order``, on a ``dtype``
    state (a float64 one cast to float32 for the scores, as the kernels
    take it)."""
    from repro_torch.core.covariance import update_cov, update_data
    from repro_torch.core.pairwise import dense_scores

    xn, c = normalized(x, dev, dtype)
    mask = torch.ones(xn.shape[0], dtype=torch.bool, device=dev)
    for r in order[:it]:
        xn, c = update_data(xn, c, r, mask), update_cov(c, r, mask)
        mask[r] = False
    xn, c = xn.float(), c.float()
    s = dense_scores(xn, c, mask)[0]
    return s, fs.score_tolerance(s, xn, c, mask)


def first_departure(got, want):
    """The first iteration where two orders differ, or None."""
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)


def hold_order(name, got, want, x, dev, dtype=torch.float32) -> bool:
    """Equal orders, or a departure at an f32 near-tie: the two roots' dense
    scores at the first differing iteration within their tolerances of each
    other (on a ``dtype`` state). Raises otherwise. Returns whether the
    orders are equal."""
    if got == want:
        return True
    k = first_departure(got, want)
    s, tol = dense_scores_along(x, want, k, dev, dtype)
    a, b = got[k], want[k]
    gap, allowed = abs(s[a] - s[b]).item(), (tol[a] + tol[b]).item()
    say("order_departure", case=name, iteration=k, root=a, reference_root=b,
        dense_score_root=f"{s[a].item():.6e}", dense_score_reference=f"{s[b].item():.6e}",
        gap=f"{gap:.3e}", allowed=f"{allowed:.3e}", near_tie=gap <= allowed)
    check(gap <= allowed, f"{name}: orders depart at iteration {k} beyond an f32 near-tie")
    return False


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_fit_hopper(dev, gpu, core):
    """``fit(score_backend="hopper")`` at the E. coli core size: one square
    launch per find-root, the orders of the other backends, B and noise
    variances as the fused fit's. Returns its launches."""
    x = core["x"]
    p, n = x.shape
    res_k, b_k, t_k = core["hopper_fused"]
    res_p = core["torch"][0]
    fit(x, ParaLiNGAMConfig(score_backend="hopper"), device=dev)  # warm-up
    reset_counts()
    (res, b), t = timed(lambda: fit(x, ParaLiNGAMConfig(score_backend="hopper"), device=dev))
    launched = counts()
    same_fused = hold_order("fit_hopper_vs_hopper_fused", res.order, res_k.order, x, dev)
    same_torch = hold_order("fit_hopper_vs_torch", res.order, res_p.order, x, dev)
    b_err = (b - b_k).abs().max().item()
    nv_err = float(np.max(np.abs(res.noise_var / res_k.noise_var - 1)))
    say("fit_hopper_ecoli", p=p, n=n, launches=launched["pairwise_moments"], find_roots=p - 1,
        update_launches=launched["rank1_update"],
        order_equals_hopper_fused=same_fused, order_equals_torch=same_torch,
        b_max_abs_diff=b_err, noise_var_max_rel_diff=nv_err, fit_s_hopper=f"{t:.4f}",
        fit_s_hopper_fused=f"{t_k:.4f}", gpu=f"'{gpu}'")
    check(launched["pairwise_moments"] == p - 1 and launched["fused_score"] == 0
          and launched["rank1_update"] == p - 1, f"{launched} launches for {p - 1} iterations")
    if same_fused:
        check(b_err <= 1e-6 and nv_err <= 1e-6, "B or noise_var differ from the fused fit")
    return launched["pairwise_moments"]


def phase_causal_order_host(dev, gpu, core):
    """The host driver (``causal_order``, ``order_backend="host"``) with the
    square and the fused kernels: the orders of ``fit``."""
    x = core["x"]
    p, n = x.shape
    fit_order = core["hopper_fused"][0].order
    for backend in ("hopper", "hopper_fused"):
        reset_counts()
        res, t = timed(lambda: causal_order(x, ParaLiNGAMConfig(score_backend=backend), device=dev))
        launched = counts()
        key = "pairwise_moments" if backend == "hopper" else "fused_score"
        same = hold_order(f"host_{backend}_vs_fit", res.order, fit_order, x, dev)
        say("causal_order_host", backend=backend, p=p, n=n, launches=launched[key],
            update_launches=launched["rank1_update"],
            order_equals_fit=same, comparisons=res.comparisons, seconds=f"{t:.4f}",
            fit_s=f"{core['hopper_fused'][2]:.4f}", gpu=f"'{gpu}'")
        check(launched[key] == p - 1 and launched["rank1_update"] == p - 1,
              f"{launched} launches for {p - 1} host iterations")


def count_reads(fn):
    """Run ``fn`` counting the threshold loop's host reads."""
    reads, orig = [0], paralingam._still_running

    def spy(run):
        reads[0] += 1
        return orig(run)

    paralingam._still_running = spy
    try:
        out = timed(fn)
    finally:
        paralingam._still_running = orig
    return out, reads[0]


def phase_threshold_ecoli(dev, gpu):
    """The configuration of examples/causal_discovery_ecoli.py (p=85,
    n=10000, seed 7, threshold, chunk 16) through ``fit`` (the scan) and
    ``causal_order`` (the host driver), held to each other and to the dense
    fused order; and a p=8 threshold fit held to the float64 oracle."""
    p, n = ECOLI
    data = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=7))
    x = data["x"]
    cfg = ParaLiNGAMConfig(threshold=True, chunk=16)
    fit(x, ParaLiNGAMConfig(), device=dev)  # warm-up
    (dense, _), t_dense = timed(lambda: fit(x, ParaLiNGAMConfig(), device=dev))
    ((scan, b), t_scan), reads_scan = count_reads(lambda: fit(x, cfg, device=dev))
    (host, t_host), reads_host = count_reads(lambda: causal_order(x, cfg, device=dev))
    scan_host = hold_order("threshold_scan_vs_host", scan.order, host.order, x, dev)
    scan_dense = hold_order("threshold_scan_vs_dense", scan.order, dense.order, x, dev)
    host_dense = hold_order("threshold_host_vs_dense", host.order, dense.order, x, dev)
    for name, r, t, reads in (("scan", scan, t_scan, reads_scan), ("host", host, t_host, reads_host)):
        say("threshold_ecoli", driver=name, p=p, n=n, chunk=16, comparisons=r.comparisons,
            comparisons_dense=r.comparisons_dense, saving_vs_serial=f"{r.saving_vs_serial:.4f}",
            rounds=r.rounds, converged=r.converged, host_reads=reads,
            valid_order=sem.is_valid_causal_order(r.order, data["b_true"]),
            seconds=f"{t:.4f}", dense_fit_s=f"{t_dense:.4f}", gpu=f"'{gpu}'")
        check(r.converged, f"threshold {name} did not converge")
        check(0 < r.comparisons < r.comparisons_dense, f"threshold {name} counted no saving")
    say("threshold_orders", scan_equals_host=scan_host, scan_equals_dense=scan_dense,
        host_equals_dense=host_dense)
    check(bool(torch.all(torch.isfinite(b))) and np.all(np.isfinite(scan.noise_var)),
          "non-finite B or noise variances from the threshold fit")

    small = sem.generate(sem.SemSpec(p=8, n=2500, density="sparse", seed=0))
    res, _ = fit(small["x"], ParaLiNGAMConfig(threshold=True, min_bucket=8), device=dev)
    oracle = direct_lingam.causal_order(small["x"])
    say("threshold_small", p=8, n=2500, order_equals_f64_oracle=res.order == oracle,
        comparisons=res.comparisons, rounds=res.rounds)
    check(res.order == oracle, "threshold fit order differs from the float64 oracle at p=8")
    return {"fit_s": t_scan, "host_s": t_host, "dense_fit_s": t_dense}


def phase_threshold_batch(dev, gpu):
    """``fit_batch(threshold=True)`` on the ragged E. coli bucket, against
    each dataset's own one-dataset ``fit_batch`` on the same padded inputs;
    then one served round of the same requests, each result bit-identical
    to a replay of its dispatch."""
    raw = ecoli_requests()
    xs, mask, nv, _ = pack_bucket(raw, *ECOLI_BUCKET)
    cfg = ParaLiNGAMConfig(threshold=True)
    names = ("orders", "comparisons", "rounds", "converged")
    (res, t_batch), reads = count_reads(
        lambda: fit_batch(xs, cfg, n_valid=nv, mask=mask, device=dev))
    got = {k: getattr(res, k).cpu().numpy() for k in names}
    differ, t_ones = timed(lambda: batch_differences(res, xs, mask, nv, cfg,
                                                     [x.shape[0] for x in raw], names, dev))
    same = len(raw) - len({d.split(":")[0] for d in differ})
    comps = [int(got["comparisons"][i, :x.shape[0] - 1].sum()) for i, x in enumerate(raw)]
    dense = [sum(r * (r - 1) // 2 for r in range(2, x.shape[0] + 1)) for x in raw]
    say("threshold_batch", B=len(raw), bucket=f"{ECOLI_BUCKET}", seconds=f"{t_batch:.4f}",
        one_dataset_fit_batch_s=f"{t_ones:.4f}", host_reads=reads,
        equal_to_own_fit_batch=f"{same}/{len(raw)}", first_differences=",".join(differ) or "none",
        saving_vs_serial=",".join(f"{1 - c / (2 * d):.3f}" for c, d in zip(comps, dense)),
        converged=bool(res.converged.all()), gpu=f"'{gpu}'")
    check(same == len(raw), "a dataset's threshold fit differs between its batch and its own")
    check(bool(res.converged.all()), "a threshold fit in the bucket did not converge")

    results, wall, st, served, _, launched, _ = engine_round(cfg, raw, dev)
    replay_ok = replay_identical(served, cfg, dev)
    say("threshold_engine", requests=len(raw), dispatches=st["dispatches"], wall_s=f"{wall:.4f}",
        requests_per_s=f"{len(raw) / wall:.3f}",
        results_bit_identical_to_replay=f"{replay_ok}/{len(raw)}",
        launches=sum(launched.values()), gpu=f"'{gpu}'")
    check(replay_ok == len(raw), "a served threshold result differs from the replay of its dispatch")


def phase_threshold_slice(dev, gpu):
    """A threshold fit at the iJR904 slice size (p=512, n=2000), for its
    comparisons, rounds and time beside the dense fit's. Its orders mean
    nothing: this SEM is degenerate in f32 (ROADMAP.md queue 3)."""
    p, n = SLICE
    x = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=1))["x"]
    (dense, _), t_dense = timed(lambda: fit(x, ParaLiNGAMConfig(), device=dev))
    ((res, _), t), reads = count_reads(
        lambda: fit(x, ParaLiNGAMConfig(threshold=True, chunk=16), device=dev))
    say("threshold_slice", p=p, n=n, chunk=16, comparisons=res.comparisons,
        comparisons_dense=res.comparisons_dense, saving_vs_serial=f"{res.saving_vs_serial:.4f}",
        rounds=res.rounds, converged=res.converged, host_reads=reads, seconds=f"{t:.4f}",
        dense_fit_s=f"{t_dense:.4f}", order_equals_dense=res.order == dense.order, held=False,
        gpu=f"'{gpu}'")
    check(res.converged, "the p=512 threshold fit did not converge")


def phase_fit_batch_hopper(dev, gpu, batch_orders):
    """``fit_batch(score_backend="hopper")`` on the E. coli bucket: one
    batched square launch per find-root, the fused backend's orders."""
    raw = ecoli_requests()
    xs, mask, nv, _ = pack_bucket(raw, *ECOLI_BUCKET)
    cfg = ParaLiNGAMConfig(score_backend="hopper")
    reset_counts()
    res, t = timed(lambda: fit_batch(xs, cfg, n_valid=nv, mask=mask, device=dev))
    launched = counts()
    orders = res.orders.cpu().numpy()
    same = sum(list(orders[i, :x.shape[0]]) == o for i, (x, o) in enumerate(zip(raw, batch_orders)))
    say("fit_batch_hopper", B=len(raw), bucket=f"{ECOLI_BUCKET}", launches=launched["pairwise_moments_batch"],
        update_launches=launched["rank1_update"],
        find_roots=ECOLI_BUCKET[0] - 1, orders_equal_to_hopper_fused=f"{same}/{len(raw)}",
        seconds=f"{t:.4f}", gpu=f"'{gpu}'")
    check(launched["pairwise_moments_batch"] == ECOLI_BUCKET[0] - 1 and launched["pairwise_moments"] == 0
          and launched["rank1_update"] == ECOLI_BUCKET[0] - 1,
          f"{launched} launches for {ECOLI_BUCKET[0] - 1} iterations")
    for i, (x, o) in enumerate(zip(raw, batch_orders)):
        if list(orders[i, :x.shape[0]]) != o:
            hold_order(f"fit_batch_hopper[{i}]", list(orders[i, :x.shape[0]]), o, x, dev)
    return launched["pairwise_moments_batch"]


# -- slice 4: the rank-1 update kernels, the SSD decode kernel, Mamba2 serving

COV_SOURCE = "src/repro_torch/kernels/csrc/covupdate.cu"
DATA_REPLACES = "src/repro/kernels/covupdate.py:21"
COV_REPLACES = "src/repro/kernels/covupdate.py:29"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_decode.cu"
SSD_REPLACES = "src/repro/kernels/ssd_decode.py:27"
# Kernel against plain: the rtol/atol of tests/test_kernels.py, which holds
# the Pallas kernels to the same formulas: 1e-5 (data, decode step; 1e-6
# atol on the covariance). Both sides round each product and sum on its own;
# only y's N-term sum of the decode step is taken in another order.
RTOL, ATOL, COV_ATOL = 1e-5, 1e-5, 1e-6
# Mamba2-370M serving at the shape of examples/serve_lm.py.
SERVE_B, SERVE_PROMPT, SERVE_NEW = 4, 32, 16
# A greedy token of the card may depart from the CPU's only at a near-tie:
# where the CPU's top-2 logits lie within GAP_TOL of each other. The logits
# are O(1) (unit-RMS hidden state after the final norm, a N(0, 1/d) head);
# float32 sums taken in other orders on the card and on the CPU move them by
# ~1e-5 after 48 layers (printed as prefill_logits_max_abs_diff), so a gap
# of 1e-3 is 100 times what the rounding can flip.
GAP_TOL = 1e-3


def within(k, r, atol, rtol=RTOL):
    """max |k - r|, and whether every entry is within atol + rtol |r|."""
    e = (k.double() - r.double()).abs()
    return e.max().item(), bool(torch.all(e <= atol + rtol * r.double().abs()))


def copy_rate(dev) -> float:
    """Bytes read and written per second by a device-to-device copy of a
    1 GiB float32 buffer (CUDA events)."""
    src = torch.empty(1 << 28, device=dev)
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps=10)
    return 2 * src.numel() * 4 / (ms / 1e3)


def device_ms(fn, kernel: str, reps: int = 50) -> float:
    """Device time per launch of the kernel whose name contains ``kernel``,
    from torch.profiler over ``reps`` calls of ``fn``: the kernel's own
    execution, without the host's launch gaps that back-to-back CUDA-event
    timing of a microsecond kernel measures."""
    fn()
    torch.cuda.synchronize()
    rows = [r for r in profiled_rows(fn, reps, kernel) if kernel in r[1]]
    if not rows:
        ms = queued_event_ms(fn, reps)
        say("profiler_fallback", kernel=f"'{kernel}'", sessions=PROFILE_ATTEMPTS,
            device_events=0, timed_by="cuda_events", device_ms=f"{ms:.5f}")
        return ms
    check(len(rows) == 1, f"the profiler saw {len(rows)} kernels named like {kernel}")
    return rows[0][0] / rows[0][2] / 1e3


# Cycles of the device-side sleep queued ahead of ``queued_event_ms``'s
# calls: ~30 ms at the H100's clocks, far longer than the host takes to
# enqueue a few dozen launches.
QUEUE_SLEEP_CYCLES = 50_000_000


def queued_event_ms(fn, reps: int) -> float:
    """Device time per call of ``fn`` from a CUDA event pair around each
    call, all enqueued behind a device-side sleep: the device reaches the
    first call only after the host has queued every one, so no host launch
    gap lies between a pair. It counts every kernel ``fn`` launches, where
    ``device_ms`` counts the named one; ``device_ms`` falls back to it when
    every profiler session lost its device events."""
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    for start, stop in pairs:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(stop) for start, stop in pairs) / reps


# A torch.profiler session on the card now and then delivers no device
# events at all (seen on the H100 machine in about one session in ten, for
# kernels it had traced before): such a session is run again. Once it has
# happened in a process, the sessions run right after it were seen to lose
# theirs too, so ``device_ms`` then times with ``queued_event_ms``.
PROFILE_ATTEMPTS = 3


def profiled_rows(fn, reps: int, kernel: str = "", with_events: bool = False):
    """``device_rows`` of a profiler session over ``reps`` calls of ``fn``,
    run again (up to ``PROFILE_ATTEMPTS`` sessions) while it saw no device
    kernel named like ``kernel`` (any kernel for ""). With ``with_events``
    also returns the session's ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if any(kernel in r[1] for r in rows):
            break
        say("profiler_retry", kernel=f"'{kernel}'", attempt=attempt, device_events=0)
        time.sleep(0.5)
    return (rows, prof.key_averages()) if with_events else rows


def covupdate_inputs(p, n, dev):
    """Normalized Gaussian rows, their correlations, b = c[:, 0] with the
    root zeroed, and the root's row, as tests/test_kernels.py builds them."""
    xn, c = normalized(gauss_data(p, n, p), dev)
    b = c[:, 0].clone()
    b[0] = 0.0
    return xn, c, b, xn[0].contiguous()


def hold_covupdate(name, xn, c, b, xr):
    """Both kernels against their plain versions on one input; returns the
    max abs errors (data, covariance)."""
    kx, kc = ops.update_data(xn, xr, b), ops.update_cov(c, b)
    rx, rc = cu.update_data_ref(xn, xr, b), cu.update_cov_ref(c, b)
    torch.cuda.synchronize()
    ex, okx = within(kx, rx, ATOL)
    ec, okc = within(kc, rc, COV_ATOL)
    diag = bool(torch.all(torch.diagonal(kc) == 1))
    say("covupdate_vs_plain", case=name, p=xn.shape[0], n=xn.shape[1], max_abs_data=f"{ex:.3e}",
        max_abs_cov=f"{ec:.3e}", data_bit_equal=torch.equal(kx, rx),
        cov_bit_equal=torch.equal(kc, rc), unit_diagonal=diag, ok=okx and okc and diag)
    check(okx and okc and diag, f"{name}: a rank-1 update kernel disagrees with plain")
    return ex, ec


# The update kernel's stage split: builds of csrc/covupdate.cu edited by text
# substitution into the git-ignored build directory, as the no-math build is.
# "no_sum" keeps its data rows' loads and stores but takes a constant for the
# replay of torch.sum; "no_cov" launches no correlation tiles in fit and ring
# modes. Their device ms beside the kernel's say what holds it back. They are
# timed out of place, on inputs no launch changes: a constant scale applied in
# place again and again would drive the rows to inf and NaN, whose division
# takes a slower path.
COV_VARIANTS = {
    "no_sum": (("if (sums) {", "if (false) {"), ("total = a.sq[r.i];", "total = 1.f;"),
               ("const bool exchange = sums && k > 1;", "const bool exchange = false;")),
    "no_cov": (("  if (mode != kModeData && cov) {", "  if (mode == kModeCov && cov) {"),),
}
_variant_builds = {}


def cov_variant_path(variant: str):
    return _build.BUILD_DIR / "variants" / f"libcovupdate_{variant}.so"


def build_cov_variant(variant: str) -> str:
    """Compile one stage-split build of the update kernel; returns its path."""
    src = (_build.CSRC / "covupdate.cu").read_text()
    for old, new in COV_VARIANTS[variant]:
        check(old in src, f"{variant} build: {old!r} is not in covupdate.cu")
        src = src.replace(old, new)
    out = cov_variant_path(variant).parent
    out.mkdir(parents=True, exist_ok=True)
    (out / f"covupdate_{variant}.cu").write_text(src)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(cov_variant_path(variant)),
                    str(out / f"covupdate_{variant}.cu")], check=True, capture_output=True,
                   timeout=600)
    return str(cov_variant_path(variant))


def start_variant_builds():
    """Start every stage-split build at once, beside the other builds."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=len(COV_VARIANTS))
    for variant in COV_VARIANTS:
        _variant_builds[variant] = pool.submit(build_cov_variant, variant)
    pool.shutdown(wait=False)


@functools.cache
def cov_variant_entries(variant: str) -> dict:
    """The stage-split build's C entries, typed as the kernel's own."""
    future = _variant_builds.get(variant)
    lib = ctypes.CDLL(future.result() if future else build_cov_variant(variant))
    entries = {}
    for name, real in cu._entries().items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = real.argtypes, real.restype
        entries[name] = fn
    return entries


def variant_device_ms(variant: str, fn) -> float:
    """``device_ms`` of ``fn`` with a stage-split build in place of the
    update kernel (its results are not read)."""
    real, entries = cu._entries, cov_variant_entries(variant)
    cu._entries = lambda: entries
    try:
        return device_ms(fn, "rank1_update_kernel")
    finally:
        cu._entries = real


def stage_split(fn) -> dict:
    """``[..._kernel_time]`` fields of the stage split of ``fn``."""
    return {f"{v}_device_ms": f"{variant_device_ms(v, fn):.5f}" for v in COV_VARIANTS}


def empty_times(mode, batch, m, n, dev):
    """Event ms and device ms of an empty kernel on the grid of a ``mode``
    launch of the update kernel: the launch floor beside its time."""
    fn = lambda: cu.launch_empty(mode, batch, m, n, dev)  # noqa: E731
    return time_ms(fn, reps=200, warmup=5), device_ms(fn, "rank1_update_empty")


def phase_covupdate_kernel(dev, gpu, rate):
    """The update kernel's TPU mode (``update_data``, ``update_cov``)
    against its plain versions at the CPU tests' cases, p=85/n=10000 and
    p=512/n=2000, with times per launch beside an empty kernel's on the
    same grid."""
    errs = [hold_covupdate(f"gauss_p{p}_n{n}", *covupdate_inputs(p, n, dev))
            for p, n in ((8, 512), (21, 1000), (64, 4096), (7, 130), ECOLI, SLICE)]
    timing = {}
    for p, n in (SLICE, (64, 4096), ECOLI):
        xn, c, b, xr = covupdate_inputs(p, n, dev)
        for name, mode, kern, plain, nbytes, ops_ in (
                ("update_data", cu.MODE_DATA, lambda: cu.launch_data(xn, xr, b),
                 lambda: cu.update_data_ref(xn, xr, b), 4 * (2 * p * n + n + p), 3 * p * n),
                ("update_cov", cu.MODE_COV, lambda: cu.launch_cov(c, b),
                 lambda: cu.update_cov_ref(c, b), 4 * (2 * p * p + p), 3 * p * p)):
            if name == "update_cov" and (p, n) != SLICE:
                continue
            ms = time_ms(kern, reps=200, warmup=5)
            dev_ms = device_ms(kern, "rank1_update_kernel")
            empty_ms, empty_dev = empty_times(mode, 1, p, n, dev)
            plain_ms = time_ms(plain, reps=50, warmup=2)
            bound = max(nbytes / HBM_BPS, ops_ / FP32_FLOPS) * 1e3
            shape = f"p={p},n={n}" if name == "update_data" else f"p={p}"
            timing.setdefault(name, (ms, plain_ms, bound, shape, dev_ms, empty_dev))
            say("covupdate_kernel_time", kernel=name, shape=shape, kernel_ms=f"{ms:.5f}",
                device_ms=f"{dev_ms:.5f}", empty_kernel_ms=f"{empty_ms:.5f}",
                empty_kernel_device_ms=f"{empty_dev:.5f}",
                blocks=cu.blocks(mode, 1, p, n), plain_ms=f"{plain_ms:.5f}",
                bound_ms=f"{bound:.5f}", bound_by="bytes",
                bound_ms_at_copy_rate=f"{nbytes / rate * 1e3:.5f}",
                device_fraction_of_bound=f"{bound / dev_ms:.3f}", gpu=f"'{gpu}'")
    return max(e[0] for e in errs), max(e[1] for e in errs), timing


def phase_covupdate_path(dev, gpu, x, order):
    """The kernels' entry points on their own path: Algorithms 7 and 8 along
    a causal order of the E. coli core data, one ``ops.update_data`` and one
    ``ops.update_cov`` per iteration (b = c[:, root] with the root and the
    earlier roots zeroed). Each step's kernel outputs are held against the
    plain versions on the same inputs. Returns (launches, max errors)."""
    xn, c = normalized(x, dev)
    dead = torch.zeros(xn.shape[0], dtype=torch.bool, device=dev)
    steps = []
    reset_counts()
    for r in order[:-1]:
        b = torch.where(dead, 0.0, c[:, r])
        b[r] = 0.0
        xr = xn[r].contiguous()
        nx, nc = ops.update_data(xn, xr, b), ops.update_cov(c, b)
        steps.append((xn, c, b, xr, nx, nc))
        xn, c = nx, nc
        dead[r] = True
    launched = counts()
    ex = ec = 0.0
    ok = True
    for xn0, c0, b, xr, nx, nc in steps:
        e1, ok1 = within(nx, cu.update_data_ref(xn0, xr, b), ATOL)
        e2, ok2 = within(nc, cu.update_cov_ref(c0, b), COV_ATOL)
        ex, ec, ok = max(ex, e1), max(ec, e2), ok and ok1 and ok2
    finite = bool(torch.isfinite(xn).all() and torch.isfinite(c).all())
    say("covupdate_path", p=x.shape[0], n=x.shape[1], iterations=len(steps),
        launches_update_data=launched["update_data"], launches_update_cov=launched["update_cov"],
        max_abs_data=f"{ex:.3e}", max_abs_cov=f"{ec:.3e}", finite=finite, ok=ok, gpu=f"'{gpu}'")
    check(launched["update_data"] == launched["update_cov"] == len(steps),
          f"{launched} launches for {len(steps)} rank-1 updates")
    check(ok and finite, "a rank-1 update on the entry path disagrees with plain")
    return launched, ex, ec


# -- slice 7: the update kernel's fit mode, on the path of every fit

RANK1_REPLACES = ("src/repro/kernels/covupdate.py:21,29; "
                  "src/repro/core/covariance.py:98,128")


def capture_updates(fn):
    """Run ``fn`` with ``ops.rank1_update`` spied on: the inputs of its
    first call at each buffer size m, copied before the call (the scan may
    update in place)."""
    captured, orig = {}, ops.rank1_update

    def spy(xb, cb, roots, mloc, n_valid=None, *, inplace=False):
        if xb.shape[1] not in captured:
            captured[xb.shape[1]] = tuple(None if t is None else t.clone()
                                          for t in (xb, cb, roots, mloc, n_valid))
        return orig(xb, cb, roots, mloc, n_valid, inplace=inplace)

    ops.rank1_update = spy
    try:
        fn()
    finally:
        ops.rank1_update = orig
    return captured


def rank1_live(xb, roots, mloc):
    return mloc & (torch.arange(xb.shape[1], device=xb.device) != roots[:, None])


def hold_rank1(name, xb, cb, roots, mloc, nv, **force):
    """The fit mode against its plain version on one launch's inputs: c'
    and x' bit-equal, each live row's scale within ``cu.SCALE_ULP_TOL`` ulp, columns
    past the valid count +0, dead rows unchanged, and the in-place launch
    the bits of the out-of-place one. ``force``: a forced plan (``cluster``,
    ``rows``). Returns the max abs error of x'."""
    kx, kc = cu.launch_rank1(xb, cb, roots, mloc, nv, **force)
    rx, rc = cu.rank1_update_ref(xb, cb, roots, mloc, n_valid=nv)
    own = xb.clone()
    ix, ic = cu.launch_rank1(own, cb, roots, mloc, nv, inplace=True, **force)
    torch.cuda.synchronize()
    live = rank1_live(xb, roots, mloc)
    ulps = cu.scale_ulps(kx, rx, xb, cb, roots, mloc)
    rows = torch.all(kx == rx, dim=-1)[live]
    n = xb.shape[2]
    past = torch.arange(n, device=xb.device) >= (n if nv is None else nv[:, None, None])
    padded_zero = bool(torch.all(kx.masked_select(past.expand_as(kx)) == 0))
    dead_same = torch.equal(kx[~live], xb[~live])
    in_place = torch.equal(ix, kx) and torch.equal(ic, kc)
    err = (kx.double() - rx.double()).abs().max().item()
    ok = (torch.equal(kc, rc) and torch.equal(kx, rx) and float(ulps.max()) <= cu.SCALE_ULP_TOL
          and padded_zero and dead_same and in_place)
    plan = cu.update_plan(cu.MODE_FIT, *xb.shape, **force)
    say("rank1_update_vs_plain", case=name, B=xb.shape[0], m=xb.shape[1], n=n,
        path=PATH_NAMES[plan["path"]], cluster=plan["k"], rows_per_block=plan["rows"],
        n_valid="none" if nv is None else f"{int(nv.min())}-{int(nv.max())}",
        live_rows=int(live.sum()), cb_bit_equal=torch.equal(kc, rc), xb_bit_equal=torch.equal(kx, rx),
        rows_bit_equal=f"{int(rows.sum())}/{rows.numel()}", scale_max_ulp=f"{float(ulps.max()):.3f}",
        scale_ulp_tol=cu.SCALE_ULP_TOL, max_abs_x=f"{err:.3e}", padded_columns_zero=padded_zero,
        dead_rows_unchanged=dead_same, in_place_bit_equal=in_place, ok=ok)
    check(ok, f"{name}: the update kernel's fit mode disagrees with plain")
    return err


PATH_NAMES = {cu.PATH_CLUSTER: "cluster", cu.PATH_WARPS: "warp_rows", cu.PATH_ROW: "row"}


def plan_fields(kind, batch, m, n) -> dict:
    """The data rows' plan of a launch, as ``[..._kernel_time]`` fields."""
    plan = cu.update_plan(kind, batch, m, n)
    return dict(path=PATH_NAMES[plan["path"]], cluster=plan["k"], rows_per_block=plan["rows"],
                smem_bytes=plan["smem"])


def forced_bucket(shapes, m, n_pad, seed, dev):
    """A bucket as the scan holds it (dataset i's p_i rows normalized over
    its n_i valid samples, zeros past them), its correlations, two earlier
    roots dead but holding data and one live root each."""
    rng = np.random.default_rng(seed)
    x = torch.zeros((len(shapes), m, n_pad), device=dev)
    mask = torch.zeros((len(shapes), m), dtype=torch.bool, device=dev)
    for i, (p, n) in enumerate(shapes):
        x[i, :p, :n] = torch.from_numpy(rng.standard_normal((p, n)).astype(np.float32))
        mask[i, :p] = True
    nv = torch.tensor([n for _, n in shapes], dtype=torch.int32, device=dev)
    xn = torch.where(mask[..., None], normalize(x, n_valid=nv), 0.0).contiguous()
    c = cov_matrix(xn, n_valid=nv).contiguous()
    roots = []
    for i, (p, _) in enumerate(shapes):
        rows = rng.permutation(p)
        mask[i, torch.from_numpy(rows[:2]).to(dev)] = False
        roots.append(int(rows[2]))
    return xn, c, torch.tensor(roots, device=dev), mask, nv


# [rank1_update_vs_plain]'s forced plans: each cluster size, several rows
# per block, odd n (every shift, the scalar path), a valid count ending
# mid-run, a row torch sums over 18 blocks (read twice), fewer than 16 rows.
FORCED_CASES = (("cluster1_p85", [(85, 10_000)], 128, 10_000, dict(cluster=1)),
                ("cluster2_p85", [(85, 10_000)], 128, 10_000, dict(cluster=2)),
                ("cluster4_mid_run", [(60, 9000), (64, 8500)], 64, 9216, dict(cluster=4)),
                ("rows8_p512", [(512, 2000)], 512, 2000, dict(rows=8)),
                ("rows4_ragged", [(30, 1000), (25, 777), (32, 513)], 32, 1024, dict(rows=4)),
                ("row_odd_n", [(37, 1301), (20, 1000)], 37, 1301, {}),
                ("row_long", [(16, 140_000)], 16, 140_000, {}),
                ("row_few", [(8, 3000)], 8, 3000, {}))


def phase_update_plan(dev):
    """The kernel's own plan of its data rows equals ``cu.update_plan``'s
    on this card at the main path's shapes and forced plans."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = ((cu.MODE_FIT, 1, 128, 10_000), (cu.MODE_FIT, 1, 512, 2000),
              (cu.MODE_FIT, 8, 128, 16384), (cu.MODE_FIT, 8, 64, 16384),
              (cu.MODE_FIT, 8, 32, 16384), (cu.MODE_RING, 64, 128, 10_000),
              (cu.MODE_RING, 64, 128, 5000), (cu.MODE_FIT, 2, 37, 1301),
              (cu.MODE_FIT, 1, 40, 131_072))
    held = 0
    for shape in shapes:
        for force in ({}, dict(cluster=2), dict(rows=2)):
            try:
                want = cu.update_plan(*shape, sms=sms, **force)
            except ValueError:
                continue
            got = cu.kernel_plan(*shape, vec=shape[3] % 4 == 0, **force)
            flat = {**{f: int(v) for f, v in want["order"].items()},
                    **{f: int(want[f]) for f in cu.PLAN_FIELDS if f not in want["order"]}}
            check(got == flat, f"the kernel's plan {got} is not update_plan's {flat}")
            held += 1
    say("update_plan", shapes=len(shapes), plans_equal=held, sms=sms)


def rank1_bytes(xb, cb, roots, mloc, nv):
    """The bytes one launch must move: each live row's valid samples read
    and written, each dataset's root row read, c read and c' written."""
    bsz, m, n = xb.shape
    live = rank1_live(xb, roots, mloc).sum(dim=1).double()
    nvd = torch.full((bsz,), float(n), dtype=torch.float64, device=xb.device) if nv is None \
        else nv.double()
    return float((live * nvd * 8 + nvd * 4 + m * m * 8).sum())


def phase_rank1_update(dev, gpu, core):
    """The update kernel's fit mode (``ops.rank1_update``) against its plain
    version on the inputs the fits give it: the first update of each stage
    of one E. coli dispatch (B=8, m=128, 64, 32, masks and valid counts),
    of the E. coli core fit (its 128-row first stage) and of the p=512
    slice fit, and the core fit's first update with |b| at and past 1
    (clip and floor); then its time per launch at those shapes, in place as
    the scan runs all but the first update (device and event ms), beside
    the out-of-place launch, an empty kernel on the same grid, the plain
    composition and the live bytes' bound. Returns (max abs err, timing of
    the dispatch's m=128 update)."""
    xs, mask, nv, _ = pack_bucket(ecoli_requests(), *ECOLI_BUCKET)
    bucket = capture_updates(lambda: fit_batch(xs, ParaLiNGAMConfig(), n_valid=nv, mask=mask,
                                               device=dev))
    fit85 = capture_updates(lambda: fit(core["x"], ParaLiNGAMConfig(), device=dev))
    x512 = sem.generate(sem.SemSpec(p=SLICE[0], n=SLICE[1], density="sparse", seed=1))["x"]
    fit512 = capture_updates(lambda: fit(x512, ParaLiNGAMConfig(), device=dev))
    cases = [(f"ecoli_bucket_m{m}", bucket[m]) for m in sorted(bucket, reverse=True)]
    # each fit's first update, on its first stage's buffer (128 rows for p=85)
    cases += [("ecoli_fit_p85_n10000", fit85[max(fit85)]),
              ("ijr904_fit_p512_n2000", fit512[max(fit512)])]
    errs = [hold_rank1(name, *args) for name, args in cases]
    xb, cb, roots, mloc, _ = fit85[max(fit85)]
    near = cb.clone()
    r = int(roots[0])
    rows = [int(i) for i in torch.nonzero(rank1_live(xb, roots, mloc)[0])[:6]]
    near[0, rows, r] = torch.tensor([1.0000001, -1.0000001, 0.99999, -0.9999999, 1.0, -1.0],
                                    device=dev)
    errs.append(hold_rank1("clip_and_floor_p85", xb, near, roots, mloc, None))
    for name, shapes, m, n_pad, force in FORCED_CASES:
        errs.append(hold_rank1(name, *forced_bucket(shapes, m, n_pad, m + n_pad, dev), **force))

    timing = None
    for name, (xb, cb, roots, mloc, nvb) in cases:
        bsz, m, n = xb.shape
        own = xb.clone()
        fn = lambda: cu.launch_rank1(own, cb, roots, mloc, nvb, inplace=True)  # noqa: E731
        ms = time_ms(fn, reps=200, warmup=5)
        dev_ms = device_ms(fn, "rank1_update_kernel")
        out_ms = device_ms(lambda: cu.launch_rank1(xb, cb, roots, mloc, nvb),
                           "rank1_update_kernel")
        empty_ms, empty_dev = empty_times(cu.MODE_FIT, bsz, m, n, dev)
        plain_ms = time_ms(lambda: cu.rank1_update_ref(xb, cb, roots, mloc, n_valid=nvb),
                           reps=20, warmup=2)
        bound = rank1_bytes(xb, cb, roots, mloc, nvb) / HBM_BPS * 1e3
        say("rank1_update_kernel_time", case=name, B=bsz, m=m, n=n,
            live_rows=int(rank1_live(xb, roots, mloc).sum()), blocks=cu.blocks(cu.MODE_FIT, bsz, m, n),
            **plan_fields(cu.MODE_FIT, bsz, m, n),
            kernel_ms=f"{ms:.5f}", device_ms=f"{dev_ms:.5f}", out_of_place_device_ms=f"{out_ms:.5f}",
            **stage_split(lambda: cu.launch_rank1(xb, cb, roots, mloc, nvb)),
            empty_kernel_ms=f"{empty_ms:.5f}", empty_kernel_device_ms=f"{empty_dev:.5f}",
            plain_ms=f"{plain_ms:.5f}", bound_ms=f"{bound:.5f}", bound_by="bytes",
            device_fraction_of_bound=f"{bound / dev_ms:.3f}", gpu=f"'{gpu}'")
        if timing is None:
            timing = (ms, plain_ms, bound, dev_ms, empty_dev,
                      f"B={bsz},m={m},n={n},n_valid={int(nvb.min())}-{int(nvb.max())},in place")
    return max(errs), timing


def phase_rank1_sum_order(dev):
    """The fit mode's sum of squares against torch.sum on the card, bit for
    bit, at each of ``covupdate.SUM_ORDER_SHAPES``."""
    held = []
    for rows, n in cu.SUM_ORDER_SHAPES:
        x = torch.from_numpy(np.random.default_rng(rows + n).standard_normal((rows, n))
                             .astype(np.float32)).to(dev)
        got, shape = cu.sum_probe(x)
        held.append(torch.equal(got, torch.sum(torch.square(x), dim=-1)))
        say("rank1_sum_order", rows=rows, n=n, torch_block=f"{shape[0]}x{shape[1]}",
            rows_share_block=bool(shape[2]), blocks_per_row=shape[3], vectors=bool(shape[4]),
            bits_equal=held[-1])
    check(all(held), "the fit mode's sum of squares departs from torch.sum's order")


def phase_rank1_scale_probe(dev):
    """The kernel's scale function against torch's CUDA rsqrt (after the
    1e-12 floor): the same bits on every float32 in [0.25, 4) and on 2^20
    random magnitudes in [1e-14, 1e6]."""
    lo, hi = np.float32(0.25).view(np.int32), np.float32(4.0).view(np.int32)
    every = torch.arange(int(lo), int(hi), device=dev, dtype=torch.int32).view(torch.float32)
    wide = torch.from_numpy((10.0 ** np.random.default_rng(0).uniform(-14, 6, 1 << 20))
                            .astype(np.float32)).to(dev)
    same = [torch.equal(cu.scale_probe(v).view(torch.int32),
                        torch.rsqrt(torch.clamp(v, min=1e-12)).view(torch.int32))
            for v in (every, wide)]
    say("rank1_scale_probe", points=every.numel() + wide.numel(), bits_equal_to_torch_rsqrt=all(same))
    check(all(same), "the kernel's rsqrt differs from torch's on the card")


def ssd_inputs(b, h, p, n, dev, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, h, p, n)), rng.standard_normal((b, h, p)),
              rng.uniform(0.01, 0.5, (b, h)), rng.standard_normal((b, n)),
              rng.standard_normal((b, n)), -rng.uniform(0.5, 2.0, (h,)),
              rng.standard_normal((h,))]
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrays]


def hold_ssd(name, args):
    """The decode kernel against its plain version on one input: the new
    state bit-equal (both round each product and sum on its own), y within
    ATOL/RTOL. Returns the max abs error of y and of the new state."""
    yk, sk = sd.ssd_decode(*args)
    yr, sr = sd.ssd_decode_ref(*args)
    torch.cuda.synchronize()
    ey, oky = within(yk, yr, ATOL)
    es, oks = within(sk, sr, ATOL)
    same = torch.equal(sk, sr)
    say("ssd_decode_vs_plain", case=name, shape="x".join(map(str, args[0].shape)),
        max_abs_y=f"{ey:.3e}", max_abs_state=f"{es:.3e}", state_bit_equal=same,
        ok=oky and oks and same)
    check(oky and oks and same, f"{name}: the decode kernel disagrees with plain")
    return max(ey, es)


def ssd_bytes(b, h, p, n):
    """Bytes a decode step must move: the state read and the new state
    written, x and y, dt, B and C, A and D, each once."""
    return 4 * (2 * b * h * p * n + 2 * b * h * p + b * h + 2 * b * n + 2 * h)


def offset_copies(args):
    """Copies of ``args`` whose data start 4 bytes past a 16-byte boundary:
    the kernel's scalar path, on the same values."""
    out = []
    for t in args:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        out.append(view)
    return out


def decode_rows(shape, dev, seed):
    """Whether row b of a launch equals a one-row launch of the row's
    contiguous views, for every b, and a repeat launch equals the first."""
    args = ssd_inputs(*shape, dev, seed)
    y, s = sd.launch(*args)
    rows = []
    for b in range(shape[0]):
        y1, s1 = sd.launch(*[t[b:b + 1].contiguous() for t in args[:5]], *args[5:])
        rows.append(torch.equal(y1[0], y[b]) and torch.equal(s1[0], s[b]))
    repeat = all(torch.equal(u, v) for u, v in zip(sd.launch(*args), (y, s)))
    return rows, repeat, args, (y, s)


def phase_ssd_kernel(dev, gpu, rate):
    """The decode kernel against its plain version at Mamba2-370M's decode
    shape (B=4, H=32, P=64, N=128), at ragged head counts, P not a multiple
    of the kernel's 16-row P-slice and N not a multiple of 4; row b of a B=4 launch
    bit-identical to a one-row launch (N=128, and N=37 whose views are not
    16-byte aligned); the scalar path on offset copies bit-identical to the
    vector path; times per launch."""
    cfg = configs.get("mamba2-370m")
    full = (SERVE_B, cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    errs = [hold_ssd(f"random_{'x'.join(map(str, s))}", ssd_inputs(*s, dev, i))
            for i, s in enumerate((full, (3, 12, 64, 128), (2, 5, 24, 40), (1, 33, 64, 128),
                                   (2, 5, 24, 37), (2, 3, 70, 130)))]
    rows, repeat, args, (y, s) = decode_rows(full, dev, 9)
    rows37, repeat37, _, _ = decode_rows((4, 5, 24, 37), dev, 10)
    paths = all(torch.equal(u, v) for u, v in zip(sd.launch(*offset_copies(args)), (y, s)))
    say("ssd_decode_rows", B=SERVE_B, rows_bit_identical=f"{sum(rows)}/{len(rows)}",
        rows_bit_identical_n37=f"{sum(rows37)}/{len(rows37)}",
        repeat_bit_identical=repeat and repeat37, scalar_path_bit_identical=paths)
    check(all(rows) and all(rows37) and repeat and repeat37,
          "a row of the decode kernel depends on its batch or run")
    check(paths, "the decode kernel's scalar path differs from its vector path")
    return max(errs), ssd_times(args, rate, gpu)


def ssd_times(args, rate, gpu, profile=True):
    """The decode kernel's times on ``args`` (launch, wrapper, device,
    plain) beside the bytes bound; without ``profile`` no device time (no
    torch.profiler session: one in this process after the sharded phases'
    ranks, or one in a rank, left the later sessions of this process
    without device events in 3 of 4 runs on the H100 machine). Returns (ms, plain ms, bound ms,
    shape, device ms or None, wrapper ms)."""
    full = tuple(args[0].shape)
    shape = "B={},H={},P={},N={}".format(*full)
    ms = time_ms(lambda: sd.launch(*args), reps=200, warmup=5)
    wrapper_ms = time_ms(lambda: sd.ssd_decode(*args), reps=200, warmup=5)
    dev_ms = device_ms(lambda: sd.launch(*args), "ssd_decode_heads") if profile else None
    plain_ms = time_ms(lambda: sd.ssd_decode_ref(*args), reps=50, warmup=2)
    nbytes = ssd_bytes(*full)
    bound = max(nbytes / HBM_BPS, 5 * np.prod(full) / FP32_FLOPS) * 1e3
    say("ssd_decode_kernel_time", shape=shape, kernel_ms=f"{ms:.5f}",
        wrapper_ms=f"{wrapper_ms:.5f}",
        device_ms=f"{dev_ms:.5f}" if profile else "not_measured", plain_ms=f"{plain_ms:.5f}",
        bound_ms=f"{bound:.5f}", bound_by="bytes", bound_ms_at_copy_rate=f"{nbytes / rate * 1e3:.5f}",
        kernel_fraction_of_bound=f"{bound / ms:.3f}",
        device_fraction_of_bound=f"{bound / dev_ms:.3f}" if profile else "not_measured",
        gpu=f"'{gpu}'")
    return ms, plain_ms, bound, shape, dev_ms, wrapper_ms


def capture_decode_inputs(params, cfg, tokens, dev):
    """The ``ssd_decode`` inputs of every SSM layer of one real decode step
    after a prefill of ``tokens`` (attention K/V grown by the one new
    position), in layer order."""
    calls, orig = [], ops.ssd_decode

    def spy(*args):
        calls.append([a.clone() for a in args])
        return orig(*args)

    logits, caches = lm.prefill(params, tokens, cfg, max_seq=tokens.shape[1] + 1)
    ops.ssd_decode = spy
    try:
        lm.decode_step(params, torch.argmax(logits, dim=-1), caches,
                       torch.full((tokens.shape[0],), tokens.shape[1], device=dev), cfg)
    finally:
        ops.ssd_decode = orig
    return calls


def profile_call(run, fn, gpu):
    """Where one call of ``fn``'s time goes, by device kernel, and the
    device's busy share of its wall time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = timed(fn)
    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    say("profile", run=run, wall_s=f"{wall:.4f}", device_busy_s=f"{busy_us / 1e6:.4f}",
        device_busy_share=f"{busy_us / 1e6 / wall:.3f}",
        device_kernels=sum(r[2] for r in rows), gpu=f"'{gpu}'")
    say_rows(run, rows, busy_us)


def replay(params, cfg, prompts, tokens, step, dev="cpu", enc=None):
    """The engine's greedy loop on ``dev`` up to decode step ``step``, fed
    ``tokens``: the logits from which token ``step`` is drawn (``enc``: an
    encoder-decoder model's frames)."""
    s = prompts.shape[1]
    padded = np.pad(prompts, ((0, 0), (0, bucket_dim(s) - s)))
    logits, caches = lm.prefill(params, torch.as_tensor(padded, dtype=torch.int64, device=dev), cfg,
                                max_seq=padded.shape[1] + step, enc_in=enc_on(enc, dev))
    for i in range(step):
        tok = torch.as_tensor(tokens[:, i], dtype=torch.int64, device=dev)
        logits, caches = lm.decode_step(params, tok, caches,
                                        torch.full((len(tok),), s + i, device=dev), cfg)
    return logits


def cpu_top2_gap(params, cfg, prompts, tokens, step, row, enc=None):
    """The CPU run's top-2 logit gap of sequence ``row`` at decode step
    ``step``, replaying its greedy loop (``tokens`` are its own)."""
    top = torch.topk(replay(params, cfg, prompts, tokens, step, enc=enc)[row].double(), 2).values
    return float(top[0] - top[1])


def phase_mamba2_serve(dev, gpu, profile=False):
    """Mamba2-370M at full width and depth (48 layers, vocab 50280) through
    ``Engine.generate`` on the card: B=4 prompts of 32 tokens, 16 new tokens,
    768 decode-kernel launches; greedy tokens against a CPU run of the same
    weights; the kernel against plain on inputs of layers 0 and 47 of a
    real decode step. Returns (launches, max error, prefill and decode times)."""
    cfg = configs.get("mamba2-370m")
    params, init_s = timed(lambda: lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev))
    prompts = serve_prompts(cfg)
    want = cfg.n_layers * SERVE_NEW
    out, wall, peak_gb, launched = generate_on(params, cfg, prompts, dev, gpu, {"ssd_decode": want},
                                               "mamba2 float32", "mamba2_generate" if profile else None)
    prefill_s, step_s = step_times(params, cfg, prompts, dev)
    same_rows, logit_diff, cpu_s = hold_tokens_against_cpu("mamba2", cfg, params, prompts, dev)
    say("mamba2_serve", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_ssm_heads, state=f"{cfg.ssm_headdim}x{cfg.ssm_state}", vocab=cfg.vocab,
        params_m=f"{param_count(params) / 1e6:.1f}", init_s=f"{init_s:.3f}", batch=SERVE_B,
        prompt_len=SERVE_PROMPT, new_tokens=SERVE_NEW,
        ssd_decode_launches=launched["ssd_decode"],
        generate_s=f"{wall:.4f}", tok_per_s=f"{SERVE_B * SERVE_NEW / wall:.1f}",
        prefill_s=f"{prefill_s:.4f}", decode_step_s=f"{np.mean(step_s):.5f}",
        decode_step_s_min=f"{min(step_s):.5f}", peak_gb=f"{peak_gb:.3f}",
        rows_equal_to_cpu=f"{same_rows}/{SERVE_B}", prefill_logits_max_abs_diff=f"{logit_diff:.3e}",
        cpu_generate_s=f"{cpu_s:.3f}", sample=",".join(map(str, out[0][:8])), gpu=f"'{gpu}'")

    # The decode kernel on the inputs of layers 0 and 47 of a real step.
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    calls = capture_decode_inputs(params, cfg, toks, dev)
    check(len(calls) == cfg.n_layers, f"{len(calls)} decode-kernel calls in one step")
    err = max(hold_ssd(f"layer{i}", calls[i]) for i in (0, cfg.n_layers - 1))
    return launched["ssd_decode"], err, (prefill_s, float(np.mean(step_s)), wall)


# ---------------------------------------------------------------------------
# the attention families (models/attention.py, models/lm.py) and the hybrid
# ---------------------------------------------------------------------------

# Attention against attention on the card (the blocked, windowed and decode
# forms against the masked full form): the CPU tests' float32 tolerance, the
# same formulas with sums over the same keys taken in other orders.
ATTN_RTOL, ATTN_ATOL = 1e-4, 1e-5
# Layers of the granite-3-2b and zamba2-2.7b cuts run on the CPU beside the
# card: granite's first 8 layers; zamba2's first group (6 SSM layers and the
# shared block).
GRANITE_CUT, ZAMBA2_CUT = 8, 6
# bfloat16 weights against the float32 ones they round, on the card: the
# prefill logits within this share of the largest float32 logit. Measured on
# the CPU at full width, 1 to 4 layers: 1.0-1.3% (logits up to ~4.8).
BF16_SHARE = 0.1
# The int8 KV cache at full width: the decode logits within this share of
# the largest ``forward`` logit. The reference's absolute 0.05
# (tests/test_serve.py) is set for the smoke model's logits (up to ~0.65);
# at full width (logits up to ~4.5) the error measured on the CPU at 1 to 8
# layers is 0.045-0.055, 1.0-1.2% of the scale. The smoke model on the card
# is held to the reference's own 0.05.
INT8_SHARE, INT8_SMOKE_ATOL = 0.05, 0.05


def free():
    """Return the allocator's cached blocks, so that the next phase loads
    its own weights into a free card (the previous phase's tensors are
    dropped first: ``del``, or the phase function's return)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def serve_prompts(cfg, b=SERVE_B, s=SERVE_PROMPT, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def enc_on(enc, dev):
    """An encoder-decoder model's frames (numpy) as a tensor on ``dev``."""
    return None if enc is None else torch.as_tensor(enc, device=dev)


def generate_on(params, cfg, prompts, dev, gpu, want: dict, what: str, profile_run=None,
                enc=None):
    """The main path: ``Engine.generate`` after a warm-up, with every kernel
    count set to 0 just before it and read just after; the counts must equal
    ``want`` (0 for every kernel it does not name). A second generate gives
    the same tokens; with ``profile_run`` a third runs under the profiler.
    ``enc``: an encoder-decoder model's frames. Returns (tokens, seconds,
    peak GB, the launches counted)."""
    eng = Engine(params, cfg, ServeConfig(max_new_tokens=SERVE_NEW), device=dev)
    eng.generate(prompts, enc=enc)  # warm-up: library handles, allocator
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, wall = timed(lambda: eng.generate(prompts, enc=enc))
    launched = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect = {k: want.get(k, 0) for k in launched}
    check(launched == expect, f"{what}: launches {launched}, want {expect}")
    check(out.shape == (len(prompts), SERVE_NEW) and bool(np.all((out >= 0) & (out < cfg.vocab))),
          f"{what}: tokens of shape {out.shape} outside the vocabulary")
    check(np.array_equal(out, eng.generate(prompts, enc=enc)), f"{what}: two generates differ")
    if profile_run:
        profile_call(profile_run, lambda: eng.generate(prompts, enc=enc), gpu)
    return out, wall, peak_gb, launched


def step_times(params, cfg, prompts, dev, enc=None):
    """The prefill's seconds (an encoder-decoder model's encoder included)
    and each decode step's, fed greedy tokens."""
    b, s = prompts.shape
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    (logits, caches), prefill_s = timed(lambda: lm.prefill(params, toks, cfg, max_seq=s + SERVE_NEW,
                                                           enc_in=enc_on(enc, dev)))
    tok, steps = torch.argmax(logits, dim=-1), []
    for i in range(SERVE_NEW):
        (logits, caches), t = timed(lambda: lm.decode_step(
            params, tok, caches, torch.full((b,), s + i, device=dev), cfg))
        steps.append(t)
        tok = torch.argmax(logits, dim=-1)
    return prefill_s, steps


def hold_tokens_against_cpu(tag, cfg, params, prompts, dev, enc=None):
    """Greedy tokens on the card against a CPU run of the same weights (the
    whole model, or a cut of it): equal, or departing only where the CPU's
    top-2 logits lie within ``GAP_TOL``, or (an MoE model) where the two
    runs, fed the CPU's tokens up to the departure, routed a token to other
    experts at a routing near-tie that can reach the departing row
    (``flip_in_row``). Returns (rows equal, prefill logit diff, CPU seconds)."""
    cpu_params = tree_map(lambda t: t.cpu(), params)
    scfg = ServeConfig(max_new_tokens=SERVE_NEW)
    out = Engine(params, cfg, scfg, device=dev).generate(prompts, enc=enc)
    before = sd.LAUNCHES
    cpu_out, cpu_s = timed(lambda: Engine(cpu_params, cfg, scfg, device="cpu").generate(
        prompts, enc=enc))
    check(sd.LAUNCHES == before, f"{tag}: the CPU route launched the kernel")
    toks = torch.as_tensor(prompts, dtype=torch.int64)
    cpu_logits, _ = lm.prefill(cpu_params, toks, cfg, enc_in=enc_on(enc, "cpu"))
    gpu_logits, _ = lm.prefill(params, toks.to(dev), cfg, enc_in=enc_on(enc, dev))
    v = cfg.vocab
    logit_diff = (gpu_logits[:, :v].cpu().double() - cpu_logits[:, :v].double()).abs().max().item()
    same_rows = 0
    for r in range(len(prompts)):
        if np.array_equal(out[r], cpu_out[r]):
            same_rows += 1
            continue
        k = int(np.flatnonzero(out[r] != cpu_out[r])[0])
        gap = cpu_top2_gap(cpu_params, cfg, prompts, cpu_out, k, r, enc=enc)
        routed, excuse = {}, None
        if cfg.is_moe and gap > GAP_TOL:
            flips = routing_flips(tag, params, cpu_params, cfg, prompts, cpu_out, k, dev)
            excuse = flip_in_row(flips, r, len(prompts), cfg)
            routed = {"routing_flips": len(flips), "routing_near_tie": excuse is not None}
            if excuse is not None:
                routed.update(excused_by_moe_call=excuse[0], excused_by_token=excuse[1],
                              excused_because=excuse[2])
        say("token_departure", case=tag, row=r, step=k, card_token=int(out[r, k]),
            cpu_token=int(cpu_out[r, k]), cpu_top2_gap=f"{gap:.3e}", allowed=GAP_TOL,
            near_tie=gap <= GAP_TOL, **routed)
        check(gap <= GAP_TOL or excuse is not None,
              f"{tag}: sequence {r} departs from the CPU run at step {k} beyond a near-tie")
    return same_rows, logit_diff, cpu_s


def to_bf16(params):
    """The float32 weights rounded to bfloat16, the norm scales kept in
    float32 (the layout ``init_params`` gives at ``cfg.dtype``)."""
    return tree_map(lambda t: t.to(torch.bfloat16) if t.ndim >= 2 else t, params)


def int8_decode_error(params, cfg, b, s, dev, seed):
    """``tests/test_serve.py::test_int8_kv_cache_close_to_bf16`` at ``cfg``:
    prefill S-1 tokens into an int8 cache of S, decode the last; returns
    (max abs diff to ``forward``'s logits, their largest magnitude, argmax
    equal, ``forward``'s top-2 gap where it differs)."""
    cfg_q = cfg.with_overrides(kv_quant="int8")
    toks = torch.as_tensor(np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)),
                           device=dev)
    full = lm.forward(params, toks, cfg)[0][:, s - 1, :cfg.vocab].double()
    _, caches = lm.prefill(params, toks[:, : s - 1], cfg_q, max_seq=s)
    check(caches["groups"][0]["pos0"][0].dtype == torch.int8, "the int8 cache is not int8")
    dec, _ = lm.decode_step(params, toks[:, s - 1], caches, torch.full((b,), s - 1, device=dev),
                            cfg_q)
    dec = dec[:, :cfg.vocab].double()
    same = torch.argmax(dec, -1) == torch.argmax(full, -1)
    top = torch.topk(full, 2).values
    gap = (top[:, 0] - top[:, 1])[~same]
    return ((dec - full).abs().max().item(), full.abs().max().item(), bool(same.all()),
            gap.max().item() if gap.numel() else 0.0)


def phase_granite_serve(dev, gpu, profile=False):
    """granite-3-2b at full width and depth (40 layers, d_model 2048, 32/8
    heads, vocab 49155, tied), float32 weights from a seeded generator,
    through ``Engine.generate`` (B=4 prompts of 32, 16 new tokens): no hand
    kernel on this path; the first 8 layers' tokens against a CPU run; then
    the same weights in bfloat16, and the int8 KV cache. Returns the float32
    parameters and config for the long prefill."""
    cfg = configs.get("granite-3-2b")
    params, init_s = timed(lambda: lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev))
    prompts = serve_prompts(cfg)
    out, wall, peak_gb, _ = generate_on(params, cfg, prompts, dev, gpu, {}, "granite float32",
                                     "granite_generate" if profile else None)
    prefill_s, steps = step_times(params, cfg, prompts, dev)

    cut_cfg = cfg.with_overrides(n_layers=GRANITE_CUT)
    cut = {**params, "groups": params["groups"][:GRANITE_CUT]}
    same_rows, logit_diff, cpu_s = hold_tokens_against_cpu("granite_cut", cut_cfg, cut, prompts, dev)
    say("granite_serve", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}", vocab=cfg.vocab,
        params_m=f"{param_count(params) / 1e6:.1f}", dtype="float32", init_s=f"{init_s:.3f}",
        batch=SERVE_B, prompt_len=SERVE_PROMPT, new_tokens=SERVE_NEW, kernel_launches=0,
        generate_s=f"{wall:.4f}", tok_per_s=f"{SERVE_B * SERVE_NEW / wall:.1f}",
        prefill_s=f"{prefill_s:.4f}", decode_step_s=f"{np.mean(steps):.5f}",
        decode_step_s_min=f"{min(steps):.5f}", peak_gb=f"{peak_gb:.3f}",
        cut_layers=GRANITE_CUT, cut_rows_equal_to_cpu=f"{same_rows}/{SERVE_B}",
        cut_prefill_logits_max_abs_diff=f"{logit_diff:.3e}", cpu_generate_s=f"{cpu_s:.3f}",
        sample=",".join(map(str, out[0][:8])), gpu=f"'{gpu}'")

    # bfloat16: the same weights rounded, against the float32 run.
    p16 = to_bf16(params)
    out16, wall16, peak16, _ = generate_on(p16, cfg, prompts, dev, gpu, {}, "granite bfloat16")
    prefill16_s, steps16 = step_times(p16, cfg, prompts, dev)
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    l32 = lm.prefill(params, toks, cfg)[0][:, :cfg.vocab].double()
    l16 = lm.prefill(p16, toks, cfg)[0][:, :cfg.vocab].double()
    d16, scale = (l16 - l32).abs().max().item(), l32.abs().max().item()
    check(d16 <= BF16_SHARE * scale,
          f"bfloat16 prefill logits {d16:.3e} from float32's, beyond {BF16_SHARE} of {scale:.3e}")
    first_equal = int((torch.argmax(l16, -1) == torch.argmax(l32, -1)).sum())
    say("granite_serve_bf16", dtype="bfloat16", generate_s=f"{wall16:.4f}",
        tok_per_s=f"{SERVE_B * SERVE_NEW / wall16:.1f}", prefill_s=f"{prefill16_s:.4f}",
        decode_step_s=f"{np.mean(steps16):.5f}", peak_gb=f"{peak16:.3f}",
        prefill_logits_max_abs_diff_vs_float32=f"{d16:.4e}", float32_logit_scale=f"{scale:.4f}",
        share=f"{d16 / scale:.4f}", allowed_share=BF16_SHARE,
        first_token_equal=f"{first_equal}/{SERVE_B}",
        rows_equal_to_float32=f"{sum(np.array_equal(a, b) for a, b in zip(out16, out))}/{SERVE_B}",
        gpu=f"'{gpu}'")
    del p16, l16, l32
    free()  # the bfloat16 copy, before the int8 runs

    # The int8 KV cache: full width, and the reference test's smoke model.
    cfg_q = cfg.with_overrides(kv_quant="int8")
    out8, wall8, peak8, _ = generate_on(params, cfg_q, prompts, dev, gpu, {}, "granite int8 KV")
    _, steps8 = step_times(params, cfg_q, prompts, dev)
    err, scale8, same8, gap8 = int8_decode_error(params, cfg, 2, 16, dev, seed=1)
    check(err <= INT8_SHARE * scale8,
          f"int8 KV decode logits {err:.3e} from forward's, beyond {INT8_SHARE} of {scale8:.3e}")
    check(same8 or gap8 <= 2 * err, "int8 KV decode changed a greedy token beyond a near-tie")
    smoke = configs.smoke("granite-3-2b")
    sp = lm.init_params(smoke, seed=0, dtype=torch.float32, device=dev)
    err_s, _, same_s, _ = int8_decode_error(sp, smoke, 2, 16, dev, seed=1)
    check(err_s < INT8_SMOKE_ATOL and same_s,
          f"int8 KV at the smoke size: {err_s:.3e} (reference bound {INT8_SMOKE_ATOL}), "
          f"argmax equal {same_s}")
    say("granite_serve_int8", kv_quant="int8", generate_s=f"{wall8:.4f}",
        tok_per_s=f"{SERVE_B * SERVE_NEW / wall8:.1f}", decode_step_s=f"{np.mean(steps8):.5f}",
        peak_gb=f"{peak8:.3f}",
        decode_vs_forward_max_abs=f"{err:.4e}", forward_logit_scale=f"{scale8:.4f}",
        share=f"{err / scale8:.4f}", allowed_share=INT8_SHARE, argmax_equal=same8,
        smoke_decode_vs_forward_max_abs=f"{err_s:.4e}", smoke_allowed=INT8_SMOKE_ATOL,
        rows_equal_to_float32_cache=f"{sum(np.array_equal(a, b) for a, b in zip(out8, out))}/{SERVE_B}",
        gpu=f"'{gpu}'")
    return params, cfg, out


def layer0_qkv(params, cfg, toks):
    """Layer 0's q, k, v (and positions) for the tokens, as the prefill
    computes them."""
    lp = params["groups"][0]["pos0"]
    b, s = toks.shape
    pos = torch.arange(s, device=toks.device)[None, :].expand(b, s)
    h = rmsnorm(embed(params["embed"], toks), lp["ln1"], cfg.norm_eps)
    return (*attn.qkv(lp["attn"], h, cfg, pos), pos)


def phase_granite_prefill_long(dev, gpu, params, cfg):
    """One 1024-token prompt at full width: ``pick_q_chunk`` gives 512, so
    every layer's blocked attention runs in 2 chunks; layer 0's q, k, v
    through ``blocked_attention`` against ``causal_attention``."""
    s = 1024
    toks = torch.as_tensor(serve_prompts(cfg, 1, s, seed=2), dtype=torch.int64, device=dev)
    lm.prefill(params, toks, cfg)  # warm-up
    reset_counts()
    (logits, _), prefill_s = timed(lambda: lm.prefill(params, toks, cfg))
    launched = counts()
    check(sum(launched.values()) == 0, f"the long prefill launched {launched}")
    check(bool(torch.all(torch.isfinite(logits[:, :cfg.vocab]))), "non-finite prefill logits")
    chunk = attn.pick_q_chunk(1, cfg.n_heads, s)
    check(chunk == 512, f"pick_q_chunk gave {chunk} at S={s}")
    q, k, v, pos = layer0_qkv(params, cfg, toks)
    blocked = attn.blocked_attention(q, k, v, pos, pos, 0, chunk)
    full = attn.causal_attention(q, k, v, pos, pos)
    diff, ok = within(blocked, full, ATTN_ATOL, ATTN_RTOL)
    check(ok, f"blocked attention in {s // chunk} chunks disagrees with causal_attention: {diff:.3e}")
    blocked_ms = time_ms(lambda: attn.blocked_attention(q, k, v, pos, pos, 0, chunk), reps=10)
    full_ms = time_ms(lambda: attn.causal_attention(q, k, v, pos, pos), reps=10)
    say("granite_prefill_long", prompt_len=s, q_chunk=chunk, chunks=s // chunk,
        prefill_s=f"{prefill_s:.4f}", prefill_tok_per_s=f"{s / prefill_s:.1f}",
        layer0_blocked_vs_causal_max_abs=f"{diff:.3e}", rtol=ATTN_RTOL, atol=ATTN_ATOL,
        blocked_ms=f"{blocked_ms:.4f}", causal_ms=f"{full_ms:.4f}", gpu=f"'{gpu}'")


def phase_gemma3_window(dev, gpu):
    """gemma3-12b at full width cut to one group (5 local layers of window
    1024 + 1 global), a 2048-token prompt: the windowed blocked path (2
    chunks, each over 2W keys) against the masked full form on layer 0, then
    decode past the window: ``decode_attention`` against the masked full
    form on layer 0's cache."""
    cfg = configs.get("gemma3-12b").with_overrides(n_layers=6)
    w, s, extra = cfg.window, 2048, 4
    params, init_s = timed(lambda: lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev))
    toks = torch.as_tensor(serve_prompts(cfg, 1, s, seed=3), dtype=torch.int64, device=dev)
    lm.prefill(params, toks, cfg, max_seq=s + extra)  # warm-up
    reset_counts()
    (logits, caches), prefill_s = timed(lambda: lm.prefill(params, toks, cfg, max_seq=s + extra))
    tok, steps = torch.argmax(logits, dim=-1), []
    for i in range(extra):
        (logits, caches), t = timed(lambda: lm.decode_step(
            params, tok, caches, torch.full((1,), s + i, device=dev), cfg))
        steps.append(t)
        tok = torch.argmax(logits, dim=-1)
    launched = counts()
    check(sum(launched.values()) == 0, f"the gemma3 path launched {launched}")
    check(bool(torch.all(torch.isfinite(logits[:, :cfg.vocab]))), "non-finite decode logits")

    q, k, v, pos = layer0_qkv(params, cfg, toks)
    blocked = attn.blocked_attention(q, k, v, pos, pos, w)
    full = attn.causal_attention(q, k, v, pos, pos, w)
    diff_b, ok_b = within(blocked, full, ATTN_ATOL, ATTN_RTOL)
    check(ok_b, f"windowed blocked attention disagrees with the masked form: {diff_b:.3e}")
    blocked_ms = time_ms(lambda: attn.blocked_attention(q, k, v, pos, pos, w), reps=10)
    full_ms = time_ms(lambda: attn.causal_attention(q, k, v, pos, pos, w), reps=10)

    # One new token at position s, past the window, over layer 0's cache.
    lp = params["groups"][0]["pos0"]
    gen = torch.Generator(device=dev).manual_seed(4)
    h = torch.randn((1, 1, cfg.d_model), generator=gen, device=dev)
    qn, kn, vn = attn.qkv(lp["attn"], h, cfg, torch.full((1, 1), s, device=dev))
    kc, vc = (t.clone() for t in caches["groups"][0]["pos0"])
    at = torch.full((1,), s, device=dev)
    attn._cache_write(kc, kn, at)
    attn._cache_write(vc, vn, at)
    kv_pos = torch.arange(kc.shape[1], device=dev)[None, :]
    dec = attn.decode_attention(qn, kc, vc, at + 1, w)
    masked = attn.causal_attention(qn, kc, vc, at[:, None], kv_pos, w)
    diff_d, ok_d = within(dec, masked, ATTN_ATOL, ATTN_RTOL)
    check(ok_d, f"decode_attention past the window disagrees with the masked form: {diff_d:.3e}")
    dec_ms = time_ms(lambda: attn.decode_attention(qn, kc, vc, at + 1, w), reps=50)
    masked_ms = time_ms(lambda: attn.causal_attention(qn, kc, vc, at[:, None], kv_pos, w), reps=50)
    say("gemma3_window", arch=cfg.name, layers=f"{cfg.local_global_ratio}x attn_w(window={w}) + 1 attn",
        d_model=cfg.d_model, heads=f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}",
        params_m=f"{param_count(params) / 1e6:.1f}", init_s=f"{init_s:.3f}", prompt_len=s,
        prefill_s=f"{prefill_s:.4f}", decode_step_s=f"{np.mean(steps):.5f}",
        layer0_windowed_blocked_vs_masked_max_abs=f"{diff_b:.3e}",
        blocked_ms=f"{blocked_ms:.4f}", masked_ms=f"{full_ms:.4f}", decode_pos=s,
        decode_vs_masked_max_abs=f"{diff_d:.3e}", decode_attention_ms=f"{dec_ms:.4f}",
        masked_decode_ms=f"{masked_ms:.4f}", rtol=ATTN_RTOL, atol=ATTN_ATOL, gpu=f"'{gpu}'")


def phase_zamba2_serve(dev, gpu, rate, profile=False):
    """zamba2-2.7b at full width and depth (54 Mamba2 layers in 9 groups,
    each closed by the shared attention block) through ``Engine.generate``:
    one ``ssd_decode`` launch per SSM layer and step (864), nothing else;
    the first group's tokens against a CPU run; the kernel against plain
    on the inputs of SSM layers 0 and 53 of a real decode step, and its
    times at this path's shape. Returns (launches, max error, timing)."""
    cfg = configs.get("zamba2-2.7b")
    params, init_s = timed(lambda: lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev))
    prompts = serve_prompts(cfg)
    ssm_layers = cfg.n_groups * cfg.hybrid_attn_every
    want = ssm_layers * SERVE_NEW
    out, wall, peak_gb, launched = generate_on(params, cfg, prompts, dev, gpu, {"ssd_decode": want},
                                               "zamba2 float32",
                                               "zamba2_generate" if profile else None)
    prefill_s, steps = step_times(params, cfg, prompts, dev)
    cut_cfg = cfg.with_overrides(n_layers=ZAMBA2_CUT)
    cut = {**params, "groups": params["groups"][:cut_cfg.n_groups]}
    same_rows, logit_diff, cpu_s = hold_tokens_against_cpu("zamba2_cut", cut_cfg, cut, prompts, dev)
    say("zamba2_serve", arch=cfg.name, ssm_layers=ssm_layers, shared_block_applications=cfg.n_groups,
        d_model=cfg.d_model, ssm_heads=cfg.n_ssm_heads, state=f"{cfg.ssm_headdim}x{cfg.ssm_state}",
        vocab=cfg.vocab, params_m=f"{param_count(params) / 1e6:.1f}", init_s=f"{init_s:.3f}",
        batch=SERVE_B, prompt_len=SERVE_PROMPT, new_tokens=SERVE_NEW,
        ssd_decode_launches=launched["ssd_decode"],
        generate_s=f"{wall:.4f}", tok_per_s=f"{SERVE_B * SERVE_NEW / wall:.1f}",
        prefill_s=f"{prefill_s:.4f}", decode_step_s=f"{np.mean(steps):.5f}",
        decode_step_s_min=f"{min(steps):.5f}", peak_gb=f"{peak_gb:.3f}",
        cut_layers=f"{ZAMBA2_CUT}+shared", cut_rows_equal_to_cpu=f"{same_rows}/{SERVE_B}",
        cut_prefill_logits_max_abs_diff=f"{logit_diff:.3e}", cpu_generate_s=f"{cpu_s:.3f}",
        sample=",".join(map(str, out[0][:8])), gpu=f"'{gpu}'")

    # The decode kernel on the inputs of SSM layers 0 and 53 of a real step.
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    calls = capture_decode_inputs(params, cfg, toks, dev)
    check(len(calls) == ssm_layers, f"{len(calls)} decode-kernel calls in one zamba2 step")
    err = max(hold_ssd(f"zamba2_layer{i}", calls[i]) for i in (0, ssm_layers - 1))
    return launched["ssd_decode"], err, ssd_times(calls[0], rate, gpu), out


# ---------------------------------------------------------------------------
# MLA and MoE (models/attention.py's mla_block, models/moe.py)
# ---------------------------------------------------------------------------

# deepseek-v2-lite's cut run on the CPU beside the card: the dense MLA
# prologue and the first 2 MLA+MoE groups, upcast to float32. llama4-scout
# is served at full width cut to its first 8 of 48 layers: its 48 x 16
# experts (~216 GB in bfloat16) do not fit one card.
DEEPSEEK_CUT_GROUPS, LLAMA4_LAYERS = 2, 8
# A routing near-tie, float32 on both sides: the CPU's k-th and (k+1)-th
# router probabilities within this gap. The router is one (T, D) x (D, E)
# float32 product and a softmax; the card and the CPU sum the product in
# other orders, which moves a probability by ~1e-7 (D=2048, logits of
# order 1), while the gap between neighbouring probabilities of 64 experts
# is ~4e-3 on these random weights.
ROUTE_TOL = 1e-5
# llama4's first MoE layer on the card against the CPU, in bfloat16: within
# this many bf16 ulps of the largest |out| (the rule of the CPU tests'
# bfloat16 tolerance, tests/test_torch_moe.py).
MOE_BF16_ULPS = 5
# Host RAM (GB, /proc/meminfo's MemAvailable, the "available" column of
# `free -g`) a CPU run needs per GB of the weights it copies: the copy,
# the activations and the caller's own copies.
HOST_RAM_FACTOR = 3


def host_ram_gb() -> tuple[float, float]:
    """(available, total) GB of host RAM, as ``free -g`` reads them."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            info[key] = int(value.split()[0]) * 1024 / 1e9
    return info["MemAvailable"], info["MemTotal"]


def capture_moe(fn):
    """Run ``fn`` with the (router, layer input (T, D)) of every MoE layer
    it runs recorded, in call order. Returns (fn's result, the calls)."""
    calls, orig = [], moe._moe_local

    def spy(params, x2d, cfg, *rest, **kw):
        calls.append((params["router"], x2d))
        return orig(params, x2d, cfg, *rest, **kw)

    moe._moe_local = spy
    try:
        out = fn()
    finally:
        moe._moe_local = orig
    return out, calls


def routing_differences(router_a, xa, router_b, xb, k):
    """The tokens whose expert set under ``router_a`` on ``xa`` differs from
    that under ``router_b`` on ``xb``: (token, b's k-th minus (k+1)-th
    probability, a's experts, b's experts)."""
    _, _, ea = moe.route(router_a, xa, k)
    pb, _, eb = moe.route(router_b, xb, k)
    ea, eb = ea.sort(-1).values.cpu(), eb.sort(-1).values.cpu()
    top = pb.sort(-1, descending=True).values.cpu().double()
    return [(t, float(top[t, k - 1] - top[t, k]), ea[t].tolist(), eb[t].tolist())
            for t in torch.nonzero((ea != eb).any(-1)).flatten().tolist()]


def hold_flips(tag, call, diffs):
    """Print each token of MoE call ``call`` that ``routing_differences``
    found routed to other experts on the card than on the CPU; raise unless
    every one lies at a routing near-tie. Returns their token indices."""
    for tok, gap, card_e, cpu_e in diffs:
        say("routing_near_tie", case=tag, moe_call=call, token=tok, card_experts=card_e,
            cpu_experts=cpu_e, cpu_gap=f"{gap:.3e}", allowed=ROUTE_TOL, near_tie=gap <= ROUTE_TOL)
        check(gap <= ROUTE_TOL, f"{tag}: MoE call {call} token {tok} routed to {card_e} on the "
              f"card and {cpu_e} on the CPU beyond a near-tie ({gap:.3e})")
    return [d[0] for d in diffs]


def routing_flips(tag, params, cpu_params, cfg, prompts, tokens, step, dev):
    """Both runs fed the CPU's ``tokens`` through the prefill and ``step``
    decode steps; each MoE call's routing on the card (its own input) and
    on the CPU (its own input), held by ``hold_flips``. Returns the flips as
    (MoE call, token, tokens in that call)."""
    _, card = capture_moe(lambda: replay(params, cfg, prompts, tokens, step, dev))
    _, cpu = capture_moe(lambda: replay(cpu_params, cfg, prompts, tokens, step))
    return [(i, tok, xc.shape[0])
            for i, ((rc, xc), (rp, xp)) in enumerate(zip(card, cpu))
            for tok in hold_flips(tag, i, routing_differences(rc, xc, rp, xp, cfg.top_k))]


def flip_in_row(flips, row, b, cfg):
    """The first flip (``routing_flips``) that can move sequence ``row``,
    with why: at a decode step (``b`` tokens, dropless) only the row's own
    token; at a prefill of T tokens, the row's own T/b tokens, or any token
    where capacity drops (T·k > 256) couple the rows. None if no flip can."""
    for call, tok, t in flips:
        if t == b and tok == row:
            return call, tok, "decode_step_own_token"
        if t != b and tok // (t // b) == row:
            return call, tok, "prefill_own_token"
        if t != b and t * cfg.top_k > 256:
            return call, tok, "prefill_rows_coupled_by_capacity_drops"
    return None


def hold_routing(tag, calls, k):
    """Each recorded MoE layer input, captured on the card, through its
    router on the card and on the CPU: equal expert sets or near-ties
    (``hold_flips``). Returns (token-layers held, near-ties)."""
    ties = sum(len(hold_flips(tag, i, routing_differences(router, x2d, router.cpu(), x2d.cpu(), k)))
               for i, (router, x2d) in enumerate(calls))
    return sum(x.shape[0] for _, x in calls), ties


def prefill_drops(params, cfg, prompts, dev):
    """Assignments kept and dropped by the capacity at the prefill of
    ``prompts``, summed over the MoE layers, and the capacity."""
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    _, calls = capture_moe(lambda: lm.prefill(params, toks, cfg))
    kept = dropped = 0
    for router, x2d in calls:
        _, _, eids = moe.route(router, x2d, cfg.top_k)
        cap = moe.capacity(x2d.shape[0], cfg)
        n = int((moe.arrival(eids.reshape(-1), cfg.n_experts) < cap).sum())
        kept, dropped = kept + n, dropped + eids.numel() - n
    return kept, dropped, cap


def mla_layers(cfg) -> int:
    return sum(kind in lm.MLA_KINDS for kind in lm.prologue_layout(cfg) + lm.group_layout(cfg)
               * cfg.n_groups)


def serve_moe(tag, cfg, dev, gpu, profile_run=None):
    """``cfg`` in bfloat16 (``cfg.dtype``) from a seeded generator through
    ``Engine.generate`` at the serving shape: no hand kernel, two generates
    equal, the parameter count against ``cfg.param_count()`` (which leaves
    out ``final_norm`` and each MLA layer's ``kv_norm``). Returns the
    parameters and the numbers the phase prints."""
    params, init_s = timed(lambda: lm.init_params(cfg, seed=0, device=dev))
    n = param_count(params)
    unc = cfg.d_model + mla_layers(cfg) * cfg.kv_lora_rank
    check(n - cfg.param_count() == unc,
          f"{tag}: {n} parameters, param_count {cfg.param_count()}, want a difference of {unc}")
    prompts = serve_prompts(cfg)
    out, wall, peak_gb, _ = generate_on(params, cfg, prompts, dev, gpu, {}, f"{tag} bfloat16",
                                        profile_run)
    prefill_s, steps = step_times(params, cfg, prompts, dev)
    kept, dropped, cap = prefill_drops(params, cfg, prompts, dev)
    check(kept + dropped == SERVE_B * bucket_dim(SERVE_PROMPT) * cfg.top_k
          * sum(kind in lm.MOE_KINDS for kind in lm.group_layout(cfg)) * cfg.n_groups,
          f"{tag}: {kept} + {dropped} assignments at the prefill")
    numbers = dict(
        arch=cfg.name, d_model=cfg.d_model, experts=f"{cfg.n_experts}top{cfg.top_k}"
        f"+{cfg.n_shared_experts}shared", d_ff_expert=cfg.d_ff_expert, vocab=cfg.vocab,
        params_b=f"{n / 1e9:.3f}", param_count_b=f"{cfg.param_count() / 1e9:.3f}",
        params_minus_param_count=n - cfg.param_count(), dtype=cfg.dtype, init_s=f"{init_s:.3f}",
        batch=SERVE_B, prompt_len=SERVE_PROMPT, new_tokens=SERVE_NEW, kernel_launches=0,
        generate_s=f"{wall:.4f}", tok_per_s=f"{SERVE_B * SERVE_NEW / wall:.1f}",
        prefill_s=f"{prefill_s:.4f}", decode_step_s=f"{np.mean(steps):.5f}",
        decode_step_s_min=f"{min(steps):.5f}", peak_gb=f"{peak_gb:.3f}",
        prefill_capacity=cap, prefill_assignments_kept=kept, prefill_assignments_dropped=dropped,
        sample=",".join(map(str, out[0][:8])), gpu=f"'{gpu}'")
    return params, prompts, numbers


def phase_deepseek_serve(dev, gpu, profile=False):
    """deepseek-v2-lite-16b at full width and depth (1 dense MLA prologue
    layer + 26 MLA+MoE layers, 64 experts top-6 + 2 shared, kv_lora 512,
    vocab 102400), bfloat16 weights (15.71B) through ``Engine.generate``;
    then ``[deepseek_cut]``: the prologue and the first 2 MoE groups of the
    same weights, upcast to float32, against a CPU run, the routing of the
    cut's prefill held first."""
    cfg = configs.get("deepseek-v2-lite-16b")
    params, prompts, numbers = serve_moe("deepseek", cfg, dev, gpu,
                                         "deepseek_generate" if profile else None)
    say("deepseek_serve", layers=f"{len(lm.prologue_layout(cfg))} mla + {cfg.n_groups} mla_moe",
        heads=f"{cfg.n_heads}x(nope {cfg.nope_head_dim}+rope {cfg.rope_head_dim}, v {cfg.head_dim})",
        kv_lora_rank=cfg.kv_lora_rank, **numbers)
    if profile:
        profile_decode_step("deepseek_decode_step", params, cfg, prompts, dev, gpu)

    cut_cfg = cfg.with_overrides(n_layers=1 + DEEPSEEK_CUT_GROUPS)
    cut = tree_map(lambda t: t.float(), {k: v for k, v in params.items() if k != "groups"}
                   | {"groups": params["groups"][:DEEPSEEK_CUT_GROUPS]})
    del params
    free()
    avail, total = host_ram_gb()
    cut_gb = param_count(cut) * 4 / 1e9
    check(avail >= HOST_RAM_FACTOR * cut_gb,
          f"deepseek_cut: {avail:.1f} GB of host RAM available, {HOST_RAM_FACTOR} x {cut_gb:.1f} wanted")
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    _, calls = capture_moe(lambda: lm.prefill(cut, toks, cut_cfg))
    held, ties = hold_routing("deepseek_cut", calls, cfg.top_k)
    same_rows, logit_diff, cpu_s = hold_tokens_against_cpu("deepseek_cut", cut_cfg, cut, prompts, dev)
    say("deepseek_cut", layers=f"1 mla + {DEEPSEEK_CUT_GROUPS} mla_moe", dtype="float32",
        params_b=f"{param_count(cut) / 1e9:.3f}", host_ram_available_gb=f"{avail:.1f}",
        host_ram_total_gb=f"{total:.1f}", routing_tokens_held=held, routing_near_ties=ties,
        route_tol=ROUTE_TOL, rows_equal_to_cpu=f"{same_rows}/{SERVE_B}",
        prefill_logits_max_abs_diff=f"{logit_diff:.3e}", cpu_generate_s=f"{cpu_s:.3f}",
        gpu=f"'{gpu}'")


def profile_decode_step(run, params, cfg, prompts, dev, gpu):
    """The device kernels of one decode step after the prompt's prefill,
    and the device's busy share of its wall time (torch.profiler)."""
    b, s = prompts.shape
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    logits, caches = lm.prefill(params, toks, cfg, max_seq=s + 1)
    tok, at = torch.argmax(logits, dim=-1), torch.full((b,), s, device=dev)
    profile_call(run, lambda: lm.decode_step(params, tok, caches, at, cfg), gpu)


def phase_llama4_serve(dev, gpu):
    """llama4-scout-17b-a16e at full width (d_model 5120, 40/8 heads, 16
    experts top-1 + 1 shared of 8192, vocab 202048) cut to its first 8 of
    48 layers (19.69B bfloat16 weights), through ``Engine.generate``; then
    its first MoE layer's ``moe_ffn`` on the card against the CPU on the
    hidden states of the first decode step, if the host's RAM allows."""
    cfg = configs.get("llama4-scout-17b-a16e").with_overrides(n_layers=LLAMA4_LAYERS)
    params, prompts, numbers = serve_moe("llama4", cfg, dev, gpu)
    say("llama4_serve", layers=f"{cfg.n_layers} attn_moe",
        heads=f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}",
        reduced=f"n_layers {configs.get(cfg.name).n_layers}->{cfg.n_layers}", **numbers)

    b, s = prompts.shape
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    logits, caches = lm.prefill(params, toks, cfg, max_seq=s + 1)
    _, calls = capture_moe(lambda: lm.decode_step(
        params, torch.argmax(logits, dim=-1), caches, torch.full((b,), s, device=dev), cfg))
    check(len(calls) == cfg.n_layers, f"llama4: {len(calls)} MoE calls in one decode step")
    lp = params["groups"][0]["pos0"]["moe"]
    x = calls[0][1][:, None, :]  # (B, 1, D), the layer's input at the step
    avail, total = host_ram_gb()
    moe_gb = param_count(lp) * 2 / 1e9
    if avail < HOST_RAM_FACTOR * moe_gb:
        say("llama4_moe_hold", run="skipped", host_ram_available_gb=f"{avail:.1f}",
            wanted_gb=f"{HOST_RAM_FACTOR * moe_gb:.1f}")
        return
    out, aux = moe.moe_ffn(lp, x, cfg)
    cpu_lp = tree_map(lambda t: t.cpu(), lp)
    (cpu_out, cpu_aux), cpu_s = timed(lambda: moe.moe_ffn(cpu_lp, x.cpu(), cfg))
    flips = hold_flips("llama4_layer0", 0, routing_differences(
        lp["router"], x[:, 0], cpu_lp["router"], x[:, 0].cpu(), cfg.top_k))
    keep = [t for t in range(b) if t not in flips]
    got, want = out[keep, 0].float().cpu().double(), cpu_out[keep, 0].float().double()
    scale = want.abs().max().item()
    atol = MOE_BF16_ULPS * 2.0 ** (math.floor(math.log2(scale)) - 7)
    diff = (got - want).abs().max().item()
    check(diff <= atol, f"llama4: layer 0 moe_ffn on the card {diff:.3e} from the CPU's, "
          f"beyond {atol:.3e}")
    say("llama4_moe_hold", run="decode_step_hidden_states", tokens=b, layer=0,
        host_ram_available_gb=f"{avail:.1f}", host_ram_total_gb=f"{total:.1f}",
        tokens_held=len(keep), routing_near_ties=len(flips), max_abs_diff=f"{diff:.4e}",
        allowed=f"{atol:.4e}", out_scale=f"{scale:.4f}",
        aux=f"{aux.item():.6f}", cpu_aux=f"{cpu_aux.item():.6f}", cpu_s=f"{cpu_s:.3f}",
        gpu=f"'{gpu}'")


# ---------------------------------------------------------------------------
# the encoder-decoder family (whisper) and training (models/lm.py, train/)
# ---------------------------------------------------------------------------

# Training: launch.train's defaults (--batch 8 --seq 128, lr 3e-4 with 20
# warmup steps, float32 masters, the trainer's bfloat16 compute copy,
# cfg.remat) on granite-3-2b at full width and depth, 4 steps.
TRAIN_B, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 4
# The card against the CPU on one training step: granite-3-2b at full
# width cut to 2 layers and a batch of 2, the same weights and tokens. The
# hold is split (tests/test_torch_train.py): with the bfloat16 compute copy
# the loss within BF16_LOSS_ATOL (a third of a bf16 ulp at the step-0
# loss, ~10.8) and each leaf's gradient within BF16_GRAD_NORM_TOL of the
# CPU's norm (the CPU tests measure 1.5% between the packages); then
# adamw_update on the CPU's gradients on both devices within OPT_RTOL and
# OPT_ATOL, float32 rounding of one step.
TRAIN_CUT, TRAIN_CUT_B = 2, 2
BF16_LOSS_ATOL, BF16_GRAD_NORM_TOL = 0.02, 0.05
OPT_RTOL, OPT_ATOL = 1e-6, 1e-9
# A run of granite-3-2b --preset 100m stopped after RESUME_AT steps and
# resumed to RESUME_STEPS against an uninterrupted run: the checkpoint's
# round trip bit for bit; the resumed losses within RESUME_LOSS_RTOL (the
# embedding's gradient may sum in another order from run to run on the
# card, and AdamW's first steps move a weight by ~lr * sign(g)).
RESUME_AT, RESUME_STEPS, RESUME_LOSS_RTOL = 3, 6, 1e-4


def serve_frames(cfg, b=SERVE_B, s=SERVE_PROMPT, seed=0):
    """An encoder-decoder model's frames (B, enc_len, d_model), drawn after
    the prompts from the same numpy generator, as ``launch.serve`` draws
    them."""
    rng = np.random.default_rng(seed)
    rng.integers(0, cfg.vocab, (b, s))
    return rng.standard_normal((b, cfg.enc_len, cfg.d_model)).astype(np.float32)


def phase_whisper_serve(dev, gpu, profile=False):
    """whisper-base at full width and depth (6 encoder and 6 decoder layers,
    d_model 512, enc_len 1536, vocab 51865) in bfloat16 (``cfg.dtype``)
    through ``Engine.generate(enc=)`` at the serving shape with frames of
    (4, 1536, 512): no hand kernel, two generates equal; then
    ``[whisper_hold]``: the same model in float32 on the card against the
    CPU, greedy tokens equal or departing at a near-tie (``GAP_TOL``).
    Returns the float32 model's tokens on the card (one rank), which
    ``[whisper_serve_uneven]`` is held against."""
    cfg = configs.get("whisper-base")
    params, init_s = timed(lambda: lm.init_params(cfg, seed=0, device=dev))
    prompts, enc = serve_prompts(cfg), serve_frames(cfg)
    out, wall, peak_gb, _ = generate_on(params, cfg, prompts, dev, gpu, {}, "whisper bfloat16",
                                        "whisper_generate" if profile else None, enc=enc)
    prefill_s, steps = step_times(params, cfg, prompts, dev, enc=enc)
    _, encoder_s = timed(lambda: lm._encode(params, enc_on(enc, dev), cfg))
    say("whisper_serve", arch=cfg.name, layers=f"{cfg.n_enc_layers} enc + {cfg.n_layers} xattn",
        d_model=cfg.d_model, heads=f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}",
        enc_len=cfg.enc_len, vocab=cfg.vocab, params_m=f"{param_count(params) / 1e6:.1f}",
        dtype=cfg.dtype, init_s=f"{init_s:.3f}", batch=SERVE_B, prompt_len=SERVE_PROMPT,
        new_tokens=SERVE_NEW, frames=f"{SERVE_B}x{cfg.enc_len}x{cfg.d_model}", kernel_launches=0,
        generate_s=f"{wall:.4f}", tok_per_s=f"{SERVE_B * SERVE_NEW / wall:.1f}",
        prefill_s=f"{prefill_s:.4f}", encoder_s=f"{encoder_s:.4f}",
        decode_step_s=f"{np.mean(steps):.5f}", decode_step_s_min=f"{min(steps):.5f}",
        peak_gb=f"{peak_gb:.3f}", sample=",".join(map(str, out[0][:8])), gpu=f"'{gpu}'")
    del params
    free()
    p32 = lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    tokens32 = Engine(p32, cfg, ServeConfig(max_new_tokens=SERVE_NEW), device=dev).generate(
        prompts, enc=enc)
    same_rows, logit_diff, cpu_s = hold_tokens_against_cpu("whisper", cfg, p32, prompts, dev,
                                                           enc=enc)
    say("whisper_hold", dtype="float32", layers=f"{cfg.n_enc_layers} enc + {cfg.n_layers} xattn",
        rows_equal_to_cpu=f"{same_rows}/{SERVE_B}", gap_tol=GAP_TOL,
        prefill_logits_max_abs_diff=f"{logit_diff:.3e}", cpu_generate_s=f"{cpu_s:.3f}",
        gpu=f"'{gpu}'")
    return tokens32


def train_batches(cfg, dev, batch=TRAIN_B, seq=TRAIN_SEQ, seed=0):
    """``launch.train``'s batches: ``TokenStream`` tokens on ``dev``."""
    stream = TokenStream(vocab=cfg.vocab, batch=batch, seq_len=seq, seed=seed)
    return lambda step: {"tokens": stream.tensor_batch_at(step, dev)}


def remat_memory(cfg, params, batch):
    """One ``loss_and_grads`` of ``cfg`` with and without remat: the GB the
    forward keeps for the backward (allocated after the loss minus before
    it, the bfloat16 compute copy made first) and the peak GB of each.
    Returns {remat: (saved GB, peak GB)}."""
    out = {}
    for remat in (True, False):
        c = cfg.with_overrides(remat=remat)
        kept = []

        def loss_fn(p, b):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            loss = lm.train_loss(p, b, c)
            torch.cuda.synchronize()
            kept.append(torch.cuda.memory_allocated() - before)
            return loss

        free()
        torch.cuda.reset_peak_memory_stats()
        loss_and_grads(loss_fn, params, batch)
        torch.cuda.synchronize()
        out[remat] = kept[0] / 1e9, torch.cuda.max_memory_allocated() / 1e9
    return out


def phase_granite_train(dev, gpu, profile=False):
    """granite-3-2b at full width and depth (40 layers, 2,534.0M float32
    masters) through ``trainer.train`` for 4 steps at ``launch.train``'s
    defaults, with every kernel count set to 0 just before and read just
    after (no hand kernel on this path): finite losses, step 0 below
    1.2·log(vocab_padded); the seconds of each step, tokens/s after the
    first, the peak GB with remat (5 superblocks of 8 groups); with
    ``profile``, the device kernels of one more step; then the GB its
    forward keeps for the backward with and without remat
    (``remat_memory``). Returns the losses, and for ``[dryrun_hold]`` the
    peak GB, a step's argument bytes, the bytes held beside the run
    (``Beside``) and the collectives per step (a ``CollectiveLedger``
    around ``train``)."""
    cfg = configs.get("granite-3-2b")
    params, init_s = timed(lambda: lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev))
    opt = OptimizerConfig(lr=3e-4, warmup_steps=20, total_steps=TRAIN_STEPS)
    tcfg = TrainerConfig(total_steps=TRAIN_STEPS, log_every=TRAIN_STEPS, opt=opt)
    batches = train_batches(cfg, dev)
    beside = Beside(dryrun.argument_bytes(params))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with StepArguments() as step_args, CollectiveLedger() as ledger:
        (params, opt_state, history), wall = timed(lambda: train(
            params, lambda p, b: lm.train_loss(p, b, cfg), batches, tcfg))
    launched = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    beside.stop()
    check(not any(launched.values()), f"granite_train: kernels launched {launched}")
    losses, dts = [h["loss"] for h in history], [h["dt"] for h in history]
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
          f"granite_train: losses {losses}")
    bound = 1.2 * math.log(cfg.vocab_padded)
    check(losses[0] < bound, f"granite_train: step-0 loss {losses[0]:.4f} not below {bound:.4f}")
    steady = sum(dts[1:]) / (len(dts) - 1)
    tokens = TRAIN_B * TRAIN_SEQ
    if profile:
        step = make_train_step(lambda p, b: lm.train_loss(p, b, cfg), opt)
        batch = batches(TRAIN_STEPS)
        profile_call("granite_train_step", lambda: step(params, opt_state, batch), gpu)
    del opt_state
    mem = remat_memory(cfg, params, batches(TRAIN_STEPS))
    n = param_count(params)
    say("granite_train", arch=cfg.name, layers=cfg.n_layers, params_m=f"{n / 1e6:.1f}",
        masters="float32", compute="bfloat16", remat=f"{cfg.remat_policy} "
        f"{lm._best_outer(cfg.n_groups)}x{cfg.n_groups // lm._best_outer(cfg.n_groups)}",
        init_s=f"{init_s:.3f}", batch=TRAIN_B, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
        kernel_launches=0, first_step_s=f"{dts[0]:.4f}",
        step_s=",".join(f"{d:.4f}" for d in dts[1:]), tok_per_s=f"{tokens / steady:.1f}",
        model_tflop_per_s=f"{6 * n * tokens / steady / 1e12:.1f}", train_s=f"{wall:.3f}",
        peak_gb=f"{peak_gb:.3f}", saved_gb_remat=f"{mem[True][0]:.3f}",
        saved_gb_no_remat=f"{mem[False][0]:.3f}", grad_peak_gb_remat=f"{mem[True][1]:.3f}",
        grad_peak_gb_no_remat=f"{mem[False][1]:.3f}",
        losses=",".join(f"{v:.4f}" for v in losses), step0_bound=f"{bound:.4f}", gpu=f"'{gpu}'")
    return losses, {"peak_gb": peak_gb, "arg_bytes": step_args.bytes, "beside": beside.bytes,
                    "collectives_per_step": ledger.calls / TRAIN_STEPS}


def phase_granite_train_hold(dev, gpu):
    """One training step of granite-3-2b at full width cut to 2 layers, on
    the card and on the CPU from the same float32 weights and tokens (B=2,
    S=128), under the split hold: with the bfloat16 compute copy the loss
    and each leaf's gradient; then ``adamw_update`` on the CPU's gradients
    on both devices. Prints what the card's forward keeps for the
    backward, and its peak GB, with and without remat."""
    full = configs.get("granite-3-2b")
    cfg = full.with_overrides(n_layers=TRAIN_CUT)
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    toks = TokenStream(vocab=cfg.vocab, batch=TRAIN_CUT_B, seq_len=TRAIN_SEQ, seed=0).batch_at(0)
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.int64, device=dev)}
    cpu_batch = {"tokens": torch.as_tensor(toks, dtype=torch.int64)}
    mem = remat_memory(cfg, params, batch)
    fn = lambda p, b: lm.train_loss(p, b, cfg)  # noqa: E731
    (loss, grads), card_s = timed(lambda: loss_and_grads(fn, params, batch))
    (cpu_loss, cpu_grads), cpu_s = timed(lambda: loss_and_grads(fn, cpu_params, cpu_batch))
    dloss = abs(float(loss) - float(cpu_loss))
    ratios = [float((g.cpu().double() - c.double()).norm()) / max(float(c.double().norm()), 1e-30)
              for g, c in zip(grads, cpu_grads)]
    check(dloss <= BF16_LOSS_ATOL, f"granite_train_hold: loss {float(loss):.5f} on the card, "
          f"{float(cpu_loss):.5f} on the CPU")
    check(max(ratios) <= BF16_GRAD_NORM_TOL,
          f"granite_train_hold: a gradient {max(ratios):.4f} of its norm from the CPU's")
    ocfg = OptimizerConfig(lr=3e-4, warmup_steps=0)
    p_card, p_cpu = tree_map(torch.clone, params), tree_map(torch.clone, cpu_params)
    s_card, s_cpu = init_opt_state(p_card), init_opt_state(p_cpu)
    with torch.no_grad():
        adamw_update(ocfg, p_card, tree_unflatten(params, [g.to(dev) for g in cpu_grads]), s_card)
        adamw_update(ocfg, p_cpu, tree_unflatten(cpu_params, cpu_grads), s_cpu)
    worst = 0.0
    for name, got, want in zip(("params", "m", "v"), (p_card, s_card["m"], s_card["v"]),
                               (p_cpu, s_cpu["m"], s_cpu["v"])):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            a, b = a.cpu().double(), b.double()
            excess = ((a - b).abs() - OPT_RTOL * b.abs() - OPT_ATOL).max().item()
            worst = max(worst, (a - b).abs().max().item())
            check(excess <= 0, f"granite_train_hold: adamw_update's {name} on the card beyond "
                  f"rtol {OPT_RTOL}, atol {OPT_ATOL} of the CPU's")
    say("granite_train_hold", arch=cfg.name, reduced=f"n_layers {full.n_layers}->{TRAIN_CUT}, "
        f"batch {TRAIN_B}->{TRAIN_CUT_B}", params_m=f"{param_count(params) / 1e6:.1f}",
        seq=TRAIN_SEQ, loss=f"{float(loss):.5f}", cpu_loss=f"{float(cpu_loss):.5f}",
        loss_abs_diff=f"{dloss:.3e}", loss_allowed=BF16_LOSS_ATOL,
        grad_norm_ratio_max=f"{max(ratios):.4e}", grad_allowed=BF16_GRAD_NORM_TOL,
        adamw_max_abs_diff=f"{worst:.3e}", adamw_rtol=OPT_RTOL, adamw_atol=OPT_ATOL,
        saved_gb_remat=f"{mem[True][0]:.3f}", saved_gb_no_remat=f"{mem[False][0]:.3f}",
        peak_gb_remat=f"{mem[True][1]:.3f}", peak_gb_no_remat=f"{mem[False][1]:.3f}",
        card_step_s=f"{card_s:.4f}", cpu_step_s=f"{cpu_s:.3f}", gpu=f"'{gpu}'")


def phase_train_resume(dev, gpu):
    """granite-3-2b ``--preset 100m`` through ``trainer.train``, checkpoints
    in a temporary directory: a run stopped at step 3 and resumed to step
    6 against an uninterrupted run of 6. The checkpoint of step 3 restores
    bit for bit; the resumed losses within ``RESUME_LOSS_RTOL``."""
    cfg = preset_config("granite-3-2b", "100m")
    batches = train_batches(cfg, dev)
    opt = OptimizerConfig(lr=3e-4, warmup_steps=20, total_steps=RESUME_STEPS)

    def run(total, ckpt_dir):
        params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
        tcfg = TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir, ckpt_every=RESUME_AT,
                             log_every=100, opt=opt)
        return train(params, lambda p, b: lm.train_loss(p, b, cfg), batches, tcfg)

    _, _, whole = run(RESUME_STEPS, "")
    with tempfile.TemporaryDirectory() as tmp:
        stop_p, stop_o, first = run(RESUME_AT, tmp)
        state = ckpt_lib.restore(tmp, RESUME_AT, {"params": stop_p, "opt": stop_o}, device=dev)
        pairs = list(zip(tree_leaves(state), tree_leaves({"params": stop_p, "opt": stop_o})))
        round_trip = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
        check(round_trip, "train_resume: the checkpoint of step 3 does not restore bit for bit")
        _, _, rest = run(RESUME_STEPS, tmp)
        ckpt_steps = ckpt_lib.all_steps(tmp)
    check([h["step"] for h in rest] == list(range(RESUME_AT, RESUME_STEPS)),
          f"train_resume: resumed steps {[h['step'] for h in rest]}")
    got = np.array([h["loss"] for h in first + rest])
    want = np.array([h["loss"] for h in whole])
    rel = np.abs(got - want) / np.abs(want)
    check(bool(np.all(np.isfinite(got))) and float(rel.max()) <= RESUME_LOSS_RTOL,
          f"train_resume: losses {got.tolist()} against {want.tolist()}")
    say("train_resume", arch=cfg.name, preset="100m", params_m=f"{param_count(stop_p) / 1e6:.1f}",
        steps=f"{RESUME_AT}+{RESUME_STEPS - RESUME_AT}", checkpoints=",".join(map(str, ckpt_steps)),
        checkpoint_round_trip_bit_equal=round_trip, leaves=len(pairs),
        resumed_losses_bit_equal=bool(np.array_equal(got, want)),
        loss_max_rel_diff=f"{float(rel.max()):.3e}", allowed=RESUME_LOSS_RTOL,
        deterministic_algorithms=torch.are_deterministic_algorithms_enabled(),
        losses=",".join(f"{v:.5f}" for v in got), uninterrupted=",".join(f"{v:.5f}" for v in want),
        gpu=f"'{gpu}'")


# ---------------------------------------------------------------------------
# sharded training (dist/sharding.py, launch.train --data-shards/--model-shards)
# ---------------------------------------------------------------------------

# [granite_train_tp]: launch.train's defaults at --model-shards 2.
TP_ARGV = ("--arch", "granite-3-2b", "--preset", "full", "--steps", str(TRAIN_STEPS),
           "--model-shards", "2")
# [train_sharded_hold]: granite at full width cut to SHARD_CUT layers, a
# batch of SHARD_B x TRAIN_SEQ, float32 without the bfloat16 cast; the
# sharded loss within rtol SHARD_TOL of the one-rank run's, each gathered
# gradient and each parameter after one AdamW step within SHARD_TOL of the
# one-rank leaf's norm (the CPU tests' float32 tolerance: the grids' sums
# split over ranks round apart, tests/test_torch_tp.py).
SHARD_CUT, SHARD_B, SHARD_TOL = 2, 4, 1e-5
SHARD_GRIDS = ((1, 2), (2, 1), (2, 2))
# [deepseek_ep_hold]: the prologue and DEEPSEEK_CUT_GROUPS MoE groups, a
# batch of SHARD_B x TRAIN_SEQ, at these grids (the (2, 2) local-capacity
# form is held on the CPU against the reference, tests/test_torch_tp.py).
EP_GRIDS = ((1, 2), (2, 1))
# [train_sharded_hold]'s SSM, hybrid and encoder-decoder configs
# (``hold_config``), at these grids.
SSM_HOLD_ARCHS = ("mamba2-370m", "zamba2-2.7b", "whisper-base")
SSM_HOLD_GRIDS = ((1, 2), (2, 2))
# [train_fsdp_hold]: FSDP, the train cell's rules (``with_fsdp``), on
# these configs (``fsdp_hold_config``: float32, full width, cut) and grids,
# a batch of SHARD_B x TRAIN_SEQ: the loss equal bit for bit to the same
# grid's without FSDP, the gradients and the parameters after one AdamW
# step within SHARD_TOL of each one-rank leaf's norm.
FSDP_HOLD_ARCHS = ("granite-3-2b", "deepseek-v2-lite-16b")
FSDP_HOLD_GRIDS = ((2, 1), (2, 2))
# The set of three ranks: (data, model) = UNEVEN_GRID, whose model ranks
# split the heads unevenly (granite-3-2b's 32 as 11/11/10, whisper-base's
# 8 as 3/3/2) and with them the MLP's columns and the padded vocabulary:
# ``[granite_serve_uneven]`` and ``[whisper_serve_uneven]`` (full width and
# depth, float32; tokens against the one-rank run's), then
# ``[train_sharded_hold]`` on UNEVEN_HOLD_ARCHS.
UNEVEN_GRID = (1, 3)
UNEVEN_SERVE = {"granite_serve_uneven": "granite-3-2b", "whisper_serve_uneven": "whisper-base"}
UNEVEN_HOLD_ARCHS = ("granite-3-2b", "whisper-base")
# [granite_train_fsdp]: granite-3-2b at full width and depth under FSDP at
# this (data, model) grid for FSDP_STEPS steps, its losses within
# BF16_LOSS_ATOL of [granite_train]'s first FSDP_STEPS: the first step and
# one steady one (each ~21 s, nearly all of it gloo's transfers between
# the two ranks on one card).
FSDP_GRID, FSDP_STEPS = (2, 1), 2
# Their gradients are held within SHARD_TOL of each leaf's norm, or within
# REORDER_FACTOR times the leaf's float32 rounding floor where that is
# larger: the one-rank gradients summed in another order (two half
# batches). At full width the SSM's a_log and dt_bias gradients are sums
# with heavy cancellation, and any new order of the products' sums moves
# them by ~1e-5 of their norm: the split over model ranks about as far as
# the one-rank reordering (the closest_* fields print both).
REORDER_FACTOR = 2
# Seconds a set of ranks may take before the phase fails.
RANK_TIMEOUT = 600
# The ranks' device.
RANK_DEVICE = "cuda"


def rank_main(rank, world, init, backend, jobs, out):
    """One rank of the sharded phases (a ``spawn`` process): its card, the
    process group, gloo's probe on CUDA tensors (under gloo), then each
    ``(job, kwargs)`` of ``jobs`` in turn, timed; the results, or the
    traceback, written under ``out``."""
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        if RANK_DEVICE == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        import torch.distributed as dist

        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
        try:
            results = [gloo_cuda_probe() if backend == "gloo" else None]
            for job, kwargs in jobs:
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                res = RANK_JOBS[job](**kwargs)
                res["job_s"] = time.perf_counter() - t0
                results.append(res)
                free()
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(jobs: list, world: int, timeout: float = RANK_TIMEOUT):
    """``jobs`` (``(job, kwargs)`` of ``RANK_JOBS``) on ``world`` rank
    processes: NCCL with one card per rank when there are several ranks and
    the machine has that many cards, else gloo with every rank on the one
    card. Returns (each rank's [probe, then one result per job], backend,
    cards used). A rank that fails or outlives ``timeout`` fails the phase,
    and every rank still running is stopped."""
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= world > 1 else "gloo"
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as out:
        init = "file://" + os.path.join(out, "init")
        procs = [ctx.Process(target=rank_main, args=(r, world, init, backend, jobs, out))
                 for r in range(world)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + timeout
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
        errors = [open(os.path.join(out, f"rank{r}.err")).read() for r in range(world)
                  if os.path.exists(os.path.join(out, f"rank{r}.err"))]
        names = [job for job, _ in jobs]
        check(not hung, f"{names}: ranks {hung} still running after {timeout} s")
        check(not errors and all(p.exitcode == 0 for p in procs),
              f"{names}: rank exit codes {[p.exitcode for p in procs]}\n" + "\n".join(errors))
        results = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results, backend, cards if backend == "nccl" else 1


def gloo_cuda_probe() -> dict:
    """gloo's ``all_reduce``, ``all_gather``, ``broadcast`` and
    ``reduce_scatter`` (FSDP's backward) on CUDA tensors of this rank, and
    the ring's shift (``batch_isend_irecv``, one hop along a flat ring of
    every rank, as ``dist.ring.Shards.shift`` moves a packet: gloo refuses
    a CUDA tensor to send, so the packet goes through host buffers): each
    result where it belongs and right."""
    import torch.distributed as dist

    from repro_torch.dist.ring import INTRA, Shards, ring_mesh

    r, w = dist.get_rank(), dist.get_world_size()
    x = torch.full((1024,), float(r + 1), device=RANK_DEVICE)
    dist.all_reduce(x)
    parts = [torch.empty(4, device=RANK_DEVICE) for _ in range(w)]
    dist.all_gather(parts, torch.full((4,), float(r), device=RANK_DEVICE))
    y = torch.full((8,), float(r + 7), device=RANK_DEVICE)
    dist.broadcast(y, src=0)
    # rank q sends block i as 10 q + i: rank r receives the sum over q of 10 q + r
    blocks = [torch.full((6,), float(10 * r + i), device=RANK_DEVICE) for i in range(w)]
    z = torch.empty(6, device=RANK_DEVICE)
    dist.reduce_scatter(z, blocks)
    ring = Shards(ring_mesh(None, torch.arange(w).reshape(1, w, 1), device_type=RANK_DEVICE))
    got = ring.shift({"x": torch.full((1000,), float(r + 1), device=RANK_DEVICE),
                      "i": torch.full((3,), r, dtype=torch.int64, device=RANK_DEVICE)},
                     1, INTRA).wait()
    on = lambda t: t.device.type == RANK_DEVICE  # noqa: E731
    return {"all_reduce": bool((x == w * (w + 1) / 2).all()) and on(x),
            "all_gather": all(bool((p == i).all()) and on(p) for i, p in enumerate(parts)),
            "broadcast": bool((y == 7.0).all()) and on(y),
            "reduce_scatter": bool((z == 5 * w * (w - 1) + w * r).all()) and on(z),
            "ring_shift": bool((got["x"] == float((r - 1) % w + 1)).all()
                               and (got["i"] == (r - 1) % w).all()) and on(got["x"])}


class CollectiveClock(CollectiveLedger):
    """Seconds inside ``torch.distributed``'s collectives while installed,
    each counted by the port's ``CollectiveLedger`` (``calls``: its
    records; on these paths an ``all_reduce``, an ``all_gather`` or, under
    FSDP, a ``reduce_scatter``), in all and by op. Under gloo a collective
    returns when it is done on the host, so the card is synchronized
    before each call (its queued work is not the collective's) and the host
    clock read around it; under NCCL CUDA events on the current stream time
    it."""

    def __init__(self, backend: str):
        super().__init__()
        self.backend, self.host_s, self.events = backend, {}, []

    def call(self, fn, args, kwargs):
        op = self.records[-1]["op"]  # the ledger records the call before it runs
        if self.backend == "gloo":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.host_s[op] = self.host_s.get(op, 0.0) + time.perf_counter() - t0
            return out
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        self.events.append((op, start, end))
        return out

    def by_op(self) -> dict:
        """op -> (calls, seconds) so far."""
        torch.cuda.synchronize()
        out = {op: [0, s] for op, s in self.host_s.items()}
        for op, s, e in self.events:
            out.setdefault(op, [0, 0.0])[1] += s.elapsed_time(e) / 1e3
        for r in self.records:
            out.setdefault(r["op"], [0, 0.0])[0] += 1
        return {op: tuple(v) for op, v in out.items()}

    def seconds(self) -> float:
        return sum(s for _, s in self.by_op().values())


def cublas_workspace_bytes() -> int:
    """The bytes cuBLAS's workspaces hold in the caching allocator now,
    released here (the next product allocates them again)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    return held - torch.cuda.memory_allocated()


class Beside:
    """The bytes the caching allocator holds beside a measured run that
    the run's cell does not: what is allocated at the start other than the
    cell's arguments alive then (``alive_bytes``), plus cuBLAS's
    workspaces, released at the start and read at the end (``stop``, after
    ``max_memory_allocated`` is read). Start it before
    ``reset_peak_memory_stats``."""

    def __init__(self, alive_bytes: int = 0):
        cublas_workspace_bytes()
        self.before = torch.cuda.memory_allocated() - alive_bytes
        self.bytes = None

    def stop(self) -> int:
        self.bytes = self.before + cublas_workspace_bytes()
        return self.bytes


class StepArguments:
    """While installed, the first call of a step that
    ``trainer.make_train_step`` builds records the bytes of its arguments
    (``params``, ``opt_state``, ``batch``: the distinct storages of the
    real tensors on this rank, ``dryrun.argument_bytes``) in ``bytes``;
    every later step's are the same."""

    def __init__(self):
        self.bytes, self.saved = None, None

    def __enter__(self):
        self.saved = made = trainer_mod.make_train_step

        def make(*args, **kwargs):
            step = made(*args, **kwargs)

            def counted(params, opt_state, batch):
                if self.bytes is None:
                    self.bytes = dryrun.argument_bytes((params, opt_state, batch))
                return step(params, opt_state, batch)

            return counted

        trainer_mod.make_train_step = make
        return self

    def __exit__(self, *exc):
        trainer_mod.make_train_step = self.saved


def rank_tp_train(argv):
    """[granite_train_tp] on this rank: ``launch.train.run`` on ``argv``,
    the collectives' seconds at the end of each step, a step's argument
    bytes, the bytes held beside the run (``Beside``)."""
    import torch.distributed as dist

    from repro_torch.launch import train as train_cli

    backend = dist.get_backend()
    beside = Beside()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    clock = CollectiveClock(backend)
    at_step = []
    with clock, StepArguments() as step_args:
        history, params, cfg, rank = train_cli.run(
            train_cli.parser().parse_args(list(argv)),
            hooks=[lambda step, p, m: at_step.append((clock.seconds(), clock.calls))])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    return {"losses": [h["loss"] for h in history], "dts": [h["dt"] for h in history],
            "peak_gb": peak_gb, "beside": beside.stop(), "launched": counts(),
            "params_m": param_count(params) / 1e6, "collective_s": at_step, "rank": rank,
            "arg_bytes": step_args.bytes}


def hold_leaves(got, want, names) -> tuple[float, str]:
    """The largest ||got - want|| / ||want|| over the leaves (float64), and
    the leaf's name."""
    worst = (0.0, "")
    for g, w, name in zip(got, want, names):
        w64 = w.double()
        worst = max(worst, (float((g.double() - w64).norm()) / max(float(w64.norm()), 1e-30), name))
    return worst


def train_batch(cfg, batch_size: int, dev) -> dict:
    """The sharded holds' batch: ``TokenStream`` tokens (seed 0), and an
    encoder-decoder model's frames (``enc_frames``, seed 0)."""
    from repro_torch.launch.train import enc_frames

    toks = TokenStream(vocab=cfg.vocab, batch=batch_size, seq_len=TRAIN_SEQ, seed=0).batch_at(0)
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.int64, device=dev)}
    if cfg.enc_dec:
        batch["enc"] = enc_frames(cfg, batch_size, 0, 0, dev)
    return batch


def moe_local_capacity(shards: int):
    """``moe_ffn`` of a (shards, M) grid on one rank: each of ``shards``
    blocks of the batch routed alone (capacity from its own token count),
    the router statistics averaged over the blocks before their product,
    as the sharded branch routes each batch rank's rows."""

    def ffn(params, x, cfg, rules):
        outs, fracs, pbars = [], [], []
        for part in x.chunk(shards, 0):
            out, (frac, pbar) = moe._moe_local(params, part.reshape(-1, x.shape[-1]), cfg, 0,
                                               cfg.n_experts, 1)
            outs.append(out.reshape(part.shape))
            fracs.append(frac)
            pbars.append(pbar)
        return (torch.cat(outs),
                moe._aux_from_stats(sum(fracs) / shards, sum(pbars) / shards, cfg.n_experts))

    return ffn


def fsdp_and_one_rank(cfg, batch_size: int, grid, cp: bool = False) -> dict:
    """[train_fsdp_hold]'s recipe on this rank, under the train cell's FSDP
    rules (``with_fsdp``) on a ``(data, model) = grid`` mesh, in float32:
    the FSDP loss and gradients (this rank's shards) and the same grid's
    loss without FSDP. With ``cp`` ([train_cp_hold]) the rules are the
    ``cp_seq`` train cell's (``with_context_parallel``, then FSDP where data
    > 1), and the loss without FSDP is not run. Then the one-rank run from the same weights and
    batch (a MoE config with data > 1 and model > 1 routes each batch
    shard alone there, ``moe_local_capacity``, as the sharded run does)
    and its ``adamw_update``, on each rank in turn (one full tree on the
    card at a time, and no full leaf on the wire): each rank keeps its
    pieces of the one-rank gradients and updated parameters, cut as its
    FSDP shards are, and rank 0 every MoE layer's (router, input) on both
    sides. The FSDP gradient shard is held against its piece, and
    ``adamw_update`` runs on the gradient pieces from fresh FSDP shards
    (in place: no ZeRO-1 slice, no gather), held against the updated
    pieces likewise. A hold is ||got - want|| / ||want|| of the whole
    leaf, the squares summed over every rank's piece: the mesh holds each
    piece of a leaf on as many ranks, so the ratio is the whole leaf's.
    Returns the result on rank 0, the two losses elsewhere."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import (
        NO_SHARDING, P, average_over_batch_, local_shard, make_rules, split_parts)
    from repro_torch.launch.mesh import make_local_mesh

    dev = torch.device(RANK_DEVICE)
    mesh = make_local_mesh(*grid, device_type=RANK_DEVICE)
    plain = make_rules(cfg, mesh)
    if cp:
        plain = with_context_parallel(plain)
    rules = with_fsdp(plain)
    specs = lm.param_specs(cfg, rules)
    names, spec_leaves = [n for n, _ in tree_flatten_with_names(specs)], tree_leaves(specs)
    shapes = tree_leaves(lm.param_shapes(cfg))
    full_batch = train_batch(cfg, batch_size, dev)
    batch = {k: local_shard(v, P(tuple(rules.batch_axes)), rules) for k, v in full_batch.items()}
    opt = OptimizerConfig(lr=3e-4, warmup_steps=0)
    rank = dist.get_rank()

    def run(rules_, batch_, specs_=None):
        params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev, rules=rules_)
        fn = lambda p, b: lm.train_loss(p, b, cfg, rules_)  # noqa: E731
        return capture_moe(lambda: loss_and_grads(fn, params, batch_, False, specs_, rules_))

    def pieces(leaves):
        return [local_shard(t, s, rules, split_parts(n))
                for t, s, n in zip(leaves, spec_leaves, names)]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (loss, grads), calls = run(rules, batch, specs)
    average_over_batch_(grads, rules, specs)
    torch.cuda.synchronize()
    out = {"loss": float(loss), "seconds": time.perf_counter() - t0,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if not cp:
        out["plain_loss"] = float(run(plain, batch)[0][0])  # its gradients are not averaged
    local = grid[0] if (cfg.is_moe and grid[0] > 1 and grid[1] > 1) else 1
    t_turns = time.perf_counter()
    free()  # every rank's cached blocks back before one rank at a time runs the whole model
    for turn in range(dist.get_world_size()):
        if turn == rank:
            saved = moe.moe_ffn
            if local > 1:
                moe.moe_ffn = moe_local_capacity(local)
            try:
                (one_loss, one_grads), one_calls = run(NO_SHARDING, full_batch)
            finally:
                moe.moe_ffn = saved
            want_grads = pieces(one_grads)
            one_params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
            with torch.no_grad():
                adamw_update(opt, one_params, tree_unflatten(one_params, one_grads),
                             init_opt_state(one_params))
            want_params = pieces(tree_leaves(one_params))
            del one_grads, one_params
            free()
        dist.barrier()
    out["turns_s"] = time.perf_counter() - t_turns

    squares = torch.zeros((4, len(names)), dtype=torch.float64, device=dev)
    for i, (g, want) in enumerate(zip(grads, want_grads)):
        want = want.double()
        squares[0, i], squares[1, i] = (g.double() - want).square().sum(), want.square().sum()
    del grads
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev, rules=rules)
    state = init_opt_state(params, specs, rules)
    with torch.no_grad():
        adamw_update(opt, params, tree_unflatten(specs, want_grads), state, specs=specs,
                     rules=rules)
    del want_grads
    sliced = sum(m.shape != p.shape for m, p in zip(tree_leaves(state["m"]), tree_leaves(params)))
    for i, (p, want) in enumerate(zip(tree_leaves(params), want_params)):
        want = want.double()
        squares[2, i], squares[3, i] = (p.double() - want).square().sum(), want.square().sum()
    dist.all_reduce(squares)
    if rank != 0:
        return {"loss": out["loss"], "plain_loss": out.get("plain_loss")}
    ratios = (squares[[0, 2]] / squares[[1, 3]].clamp(min=1e-60)).sqrt().cpu()
    worst = [max(zip(r.tolist(), names)) for r in ratios]
    flips = sum(len(routing_differences(rs, xs, ro, xo, cfg.top_k))  # rank 0's batch shard:
                for (rs, xs), (ro, xo) in zip(calls, one_calls[::local])) if cfg.is_moe else 0
    return {**out, "one_loss": float(one_loss), "grad_ratio": worst[0], "param_ratio": worst[1],
            "moments_sliced": sliced, "leaves": len(names),
            "fsdp_leaves": sum(s != f for s, f in zip(tree_leaves(lm.param_specs(cfg)),
                                                      spec_leaves)),
            "params_m": sum(math.prod(s) for s in shapes) / 1e6, "local_capacity": local,
            "routing_flips": flips, "rules": (rules.batch_axes, rules.model_axis),
            "fsdp_axes": rules.fsdp_axes, "context_parallel": rules.context_parallel}


def sharded_and_one_rank(cfg, batch_size: int, grid, with_step: bool, reorder: bool = False):
    """On this rank: ``cfg``'s float32 loss and gradients under ``make_rules``
    on a ``(data, model) = grid`` mesh, the gradients gathered (a split
    leaf by its parts); then on rank 0 the one-rank run from the same
    weights and batch, every MoE layer's (router, input) recorded on both
    sides. With ``with_step``, the split hold of the update: rank 0
    broadcasts the one-rank gradients, and each rank runs ``adamw_update``
    on its shards of them from fresh parameter shards, with ZeRO-1 over
    ``data``; the parameters gathered, beside the one-rank update on the
    same gradients. With ``reorder``, rank 0 also takes the one-rank
    gradients summed in another order (two half batches, averaged): each
    leaf's ||reordered - one|| / ||one|| is its float32 rounding floor.
    Returns (sharded, one-rank) on rank 0, (sharded, None) elsewhere."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import (
        NO_SHARDING, P, average_over_batch_, gather_tree, local_shard, make_rules, shard_tree)
    from repro_torch.launch.mesh import make_local_mesh

    dev = torch.device(RANK_DEVICE)
    mesh = make_local_mesh(*grid, device_type=RANK_DEVICE)
    rules = make_rules(cfg, mesh)
    specs = lm.param_specs(cfg)
    full_batch = train_batch(cfg, batch_size, dev)
    batch = {k: local_shard(v, P(tuple(rules.batch_axes)), rules) for k, v in full_batch.items()}
    opt = OptimizerConfig(lr=3e-4, warmup_steps=0)
    rank0 = dist.get_rank() == 0

    def grads_of(rules_, batch_):
        params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev, rules=rules_)
        fn = lambda p, b: lm.train_loss(p, b, cfg, rules_)  # noqa: E731
        (loss, grads), calls = capture_moe(lambda: loss_and_grads(fn, params, batch_, False))
        average_over_batch_(grads, rules_)
        return float(loss), tree_unflatten(params, grads), calls

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads, calls = grads_of(rules, batch)
    grads = gather_tree(grads, specs, rules)
    torch.cuda.synchronize()
    sharded = {"loss": loss, "grads": grads, "calls": calls,
               "seconds": time.perf_counter() - t0, "rules": (rules.batch_axes, rules.model_axis),
               "names": [name for name, _ in tree_flatten_with_names(specs)],
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    one = None
    if rank0:
        loss, one_grads, calls = grads_of(NO_SHARDING, full_batch)
        one = {"loss": loss, "grads": tree_leaves(one_grads), "calls": calls}
        if reorder:
            half = batch_size // 2
            parts = [tree_leaves(grads_of(NO_SHARDING, {k: v[rows] for k, v in
                                                       full_batch.items()})[1])
                     for rows in (slice(0, half), slice(half, None))]
            one["reordered"] = [(a + b) / 2 for a, b in zip(*parts)]
    if with_step:
        given = one["grads"] if rank0 else [torch.empty_like(g) for g in grads]
        for g in given:
            dist.broadcast(g, src=0)
        params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev, rules=rules)
        state = init_opt_state(params, specs, rules)
        shards = shard_tree(tree_unflatten(specs, given), specs, rules)
        with torch.no_grad():
            adamw_update(opt, params, shards, state, specs=specs, rules=rules)
        sharded["params"] = gather_tree(params, specs, rules)
        sharded["moments_sliced"] = sum(m.shape != p.shape for m, p in
                                        zip(tree_leaves(state["m"]), tree_leaves(params)))
        if rank0:
            params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
            with torch.no_grad():
                adamw_update(opt, params, tree_unflatten(params, given), init_opt_state(params))
            one["params"] = tree_leaves(params)
    if not rank0:
        return {"loss": sharded["loss"]}, None
    return sharded, one


def hold_config(arch: str):
    """The full-width config of ``[train_sharded_hold]``: granite and mamba2
    cut to ``SHARD_CUT`` layers, zamba2 to its first group (6 SSM layers
    and the shared block), whisper-base whole."""
    cfg = configs.get(arch)
    if arch == "zamba2-2.7b":
        return cfg.with_overrides(n_layers=ZAMBA2_CUT)
    if arch == "whisper-base":
        return cfg
    return cfg.with_overrides(n_layers=SHARD_CUT)


def rank_sharded_hold(grid, arch="granite-3-2b"):
    """[train_sharded_hold] on this rank (the result on rank 0)."""
    cfg = hold_config(arch).with_overrides(dtype="float32")
    floor = arch in SSM_HOLD_ARCHS
    sharded, one = sharded_and_one_rank(cfg, SHARD_B, grid, with_step=True, reorder=floor)
    if one is None:
        return sharded
    ratios = [hold_leaves([g], [w], [n]) for g, w, n in
              zip(sharded["grads"], one["grads"], sharded["names"])]
    floors = ([hold_leaves([g], [w], [n])[0] for g, w, n in
               zip(one["reordered"], one["grads"], sharded["names"])] if floor else
              [0.0] * len(ratios))
    allowed = [max(SHARD_TOL, REORDER_FACTOR * f) for f in floors]
    beyond = max(((r / a, r, a, f, n) for (r, n), a, f in zip(ratios, allowed, floors)))
    excess = max(float(((a.double() - b.double()).abs() - OPT_RTOL * b.double().abs()
                        - OPT_ATOL).max()) for a, b in zip(sharded["params"], one["params"]))
    return {"loss": sharded["loss"], "one_loss": one["loss"], "arch": arch,
            "layers": cfg.n_layers, "grad_ratio": hold_leaves(sharded["grads"], one["grads"],
                                                              sharded["names"]),
            "grad_beyond": beyond, "reorder_floor_max": max(floors),
            "param_max_abs_diff": max(float((a - b).abs().max())
                                      for a, b in zip(sharded["params"], one["params"])),
            "param_excess": excess, "moments_sliced": sharded["moments_sliced"],
            "leaves": len(one["grads"]), "params_m": param_count(one["params"]) / 1e6,
            "seconds": sharded["seconds"], "peak_gb": sharded["peak_gb"], "rules": sharded["rules"]}


def rank_ep_hold(grid):
    """[deepseek_ep_hold] on this rank (the result on rank 0): the routing
    of each MoE call against the one-rank run's, then the loss and the
    gathered gradients."""
    cfg = configs.get("deepseek-v2-lite-16b")
    cfg = cfg.with_overrides(n_layers=cfg.first_dense_layers + DEEPSEEK_CUT_GROUPS,
                             dtype="float32")
    sharded, one = sharded_and_one_rank(cfg, SHARD_B, grid, with_step=False)
    if one is None:
        return sharded
    flips = [(i, routing_differences(rs, xs, ro, xo, cfg.top_k))
             for i, ((rs, xs), (ro, xo)) in enumerate(zip(sharded["calls"], one["calls"]))]
    return {"loss": sharded["loss"], "one_loss": one["loss"],
            "grad_ratio": hold_leaves(sharded["grads"], one["grads"], sharded["names"]),
            "leaves": len(one["grads"]), "params_m": sum(g.numel() for g in one["grads"]) / 1e6,
            "moe_calls": len(one["calls"]), "tokens": [x.shape[0] for _, x in one["calls"]],
            "flips": flips, "seconds": sharded["seconds"], "peak_gb": sharded["peak_gb"],
            "rules": sharded["rules"], "capacity": moe.capacity(one["calls"][0][1].shape[0], cfg)}


def fsdp_hold_config(arch: str):
    """``[train_fsdp_hold]``'s float32 config: granite-3-2b at full width
    cut to ``SHARD_CUT`` layers, deepseek-v2-lite-16b to its prologue and
    ``DEEPSEEK_CUT_GROUPS`` MoE groups."""
    cfg = configs.get(arch)
    layers = (cfg.first_dense_layers + DEEPSEEK_CUT_GROUPS if arch.startswith("deepseek")
              else SHARD_CUT)
    return cfg.with_overrides(n_layers=layers, dtype="float32")


def rank_fsdp_hold(grid, arch):
    """[train_fsdp_hold] on this rank (the result on rank 0)."""
    cfg = fsdp_hold_config(arch)
    return {**fsdp_and_one_rank(cfg, SHARD_B, grid), "arch": arch, "layers": cfg.n_layers}


def rank_fsdp_train():
    """[granite_train_fsdp] on this rank: granite-3-2b at full width and
    depth through ``trainer.train`` (``make_train_step``) under FSDP over
    ``FSDP_GRID`` = (data, model), ``[granite_train]``'s weights, batches
    and optimizer (seed 0, ``TRAIN_B`` x ``TRAIN_SEQ``, lr 3e-4 after 20
    warmup steps), ``FSDP_STEPS`` steps: the losses, each step's seconds,
    the collectives' calls and seconds by op at the end of each step
    (``CollectiveClock``), a step's argument bytes (``StepArguments``),
    the peak and the bytes held beside the run (``Beside``)."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import P, local_shard, make_rules
    from repro_torch.launch.mesh import make_local_mesh

    dev = torch.device(RANK_DEVICE)
    cfg = configs.get("granite-3-2b")
    mesh = make_local_mesh(*FSDP_GRID, device_type=RANK_DEVICE)
    rules = with_fsdp(make_rules(cfg, mesh))
    specs = lm.param_specs(cfg, rules)
    beside = Beside()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev, rules=rules)
    rows = P(tuple(rules.batch_axes))
    batches = train_batches(cfg, dev, TRAIN_B, TRAIN_SEQ)
    opt = OptimizerConfig(lr=3e-4, warmup_steps=20, total_steps=TRAIN_STEPS)
    tcfg = TrainerConfig(total_steps=FSDP_STEPS, log_every=FSDP_STEPS, opt=opt)
    clock = CollectiveClock(dist.get_backend())
    at_step = []
    with clock, StepArguments() as step_args:
        params, _, history = train(
            params, lambda p, b: lm.train_loss(p, b, cfg, rules),
            lambda step: {k: local_shard(v, rows, rules) for k, v in batches(step).items()},
            tcfg, hooks=[lambda step, p, m: at_step.append(clock.by_op())], param_specs=specs,
            rules=rules)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    return {"losses": [h["loss"] for h in history], "dts": [h["dt"] for h in history],
            "peak_gb": peak_gb, "beside": beside.stop(), "launched": counts(),
            "params_m": param_count(params) / 1e6, "by_op": at_step, "rank": dist.get_rank(),
            "arg_bytes": step_args.bytes, "fsdp_axes": rules.fsdp_axes}


# ---------------------------------------------------------------------------
# context parallelism (the reference's cp_seq: the sequence over the model ranks)
# ---------------------------------------------------------------------------

# The (data, model) grid of [granite_prefill_cp] and [granite_train_cp], and
# their batch: CP_B prompts (sequences) of CP_SEQ tokens, each model rank
# running CP_SEQ / 2 positions of every row with every head.
CP_GRID, CP_B, CP_SEQ = (1, 2), 2, 2048
# [granite_prefill_cp]: CP_NEW greedy tokens decoded after the prefill under
# the plain tensor-parallel rules on its caches; the last logits and the
# caches within SHARD_TOL of the norms of the one-rank prefill's and of the
# tensor-parallel prefill's (the same split-KV layout) respectively; the
# tokens against the one-rank run's by [granite_serve_tp]'s rule (equal, or
# departing at a GAP_TOL near-tie of the one-rank logits).
CP_NEW = 8
# [granite_train_cp]: granite-3-2b at full width, CP_TRAIN_LAYERS of its 40
# layers (None: all of them), [granite_train]'s optimizer, CP_TRAIN_STEPS
# steps on TokenStream batches of CP_B x CP_SEQ, the losses within
# BF16_LOSS_ATOL of the one-rank run's on the same batches. Cut to 4
# layers: at full depth a step took 22.7 s over gloo on the one card, 91%
# of it in 848 collectives, and the job 57.8 s of the new jobs' 150.
CP_TRAIN_LAYERS, CP_TRAIN_STEPS = 4, 2
# [train_cp_hold]: [train_fsdp_hold]'s recipe under the cp_seq train cell's
# rules (FSDP where data > 1), float32, a batch of SHARD_B x TRAIN_SEQ, on
# these configs (cp_hold_config) and grids: the loss, every gradient and
# every parameter after one AdamW step within SHARD_TOL of the one-rank
# leaf's norm. gemma3-12b runs one group of its layout with its attention
# at full width (d_model, heads, head_dim), its window cut to
# CP_HOLD_WINDOW (128 positions never reach its 1024: a window of 8 is
# crossed by every block of 64 and of 32), its untied vocabulary to
# CP_HOLD_VOCAB rows (at 262144 the group held 13.4 GB of float32 leaves
# and took 59.0 s over gloo at (1, 2) alone) and its MLP to CP_HOLD_D_FF
# columns: with its 15360 the two grids' gemma3 jobs took 26.2 and 42.0 s
# (both held), which would bring the CP jobs to ~139 s of their 150.
CP_HOLD_WINDOW, CP_HOLD_VOCAB, CP_HOLD_D_FF = 8, 32768, 3840
CP_HOLD_ARCHS = ("granite-3-2b", "gemma3-12b", "deepseek-v2-lite-16b", "whisper-base")
CP_HOLD_GRIDS = ((1, 2), (2, 2))
# The context-parallel jobs and the seconds they may take together
# (``[cp_jobs]`` prints their sum, rank 0's job seconds).
CP_JOBS, CP_JOBS_S = ("prefill_cp", "train_cp", "cp_hold"), 150


def cp_train_config():
    """[granite_train_cp]'s config: granite-3-2b, cut to CP_TRAIN_LAYERS."""
    cfg = configs.get("granite-3-2b")
    return cfg if CP_TRAIN_LAYERS is None else cfg.with_overrides(n_layers=CP_TRAIN_LAYERS)


def cp_hold_config(arch: str):
    """[train_cp_hold]'s float32 config: granite-3-2b at full width cut to
    ``SHARD_CUT`` layers, gemma3-12b at full width cut to one group of its
    layout (5 layers of window ``CP_HOLD_WINDOW`` and a global one, so the
    window is held across the blocks), ``CP_HOLD_VOCAB`` rows and
    ``CP_HOLD_D_FF`` MLP columns,
    deepseek-v2-lite-16b at full width cut to its prologue and
    ``DEEPSEEK_CUT_GROUPS`` MoE groups, whisper-base whole."""
    cfg = configs.get(arch)
    if arch == "gemma3-12b":
        return cfg.with_overrides(n_layers=cfg.local_global_ratio + 1, window=CP_HOLD_WINDOW,
                                  vocab=CP_HOLD_VOCAB, d_ff=CP_HOLD_D_FF, dtype="float32")
    layers = {"granite-3-2b": SHARD_CUT,
              "deepseek-v2-lite-16b": cfg.first_dense_layers + DEEPSEEK_CUT_GROUPS,
              "whisper-base": cfg.n_layers}[arch]
    return cfg.with_overrides(n_layers=layers, dtype="float32")


def rank_cp_hold(grid, arch):
    """[train_cp_hold] on this rank (the result on rank 0)."""
    cfg = cp_hold_config(arch)
    return {**fsdp_and_one_rank(cfg, SHARD_B, grid, cp=True), "arch": arch,
            "layers": cfg.n_layers}


def greedy_steps(params, cfg, rules, caches, logits, start: int, new: int):
    """``new`` greedy decode steps under ``rules`` from a prefill's caches
    and last logits (the whole vocabulary): (the tokens (B, new), each
    step's top-2 gap of the logits it picked from)."""
    from repro_torch.dist.sharding import NO_SHARDING

    toks, gaps = [], []
    b = logits.shape[0]
    for i in range(new):
        top = torch.topk(logits[:, :cfg.vocab].double(), 2).values
        gaps.append((top[:, 0] - top[:, 1]).cpu())
        tok = torch.argmax(logits[:, :cfg.vocab], -1)
        toks.append(tok)
        pos = torch.full((b,), start + i, dtype=torch.int64, device=tok.device)
        logits, caches = lm.decode_step(params, tok, caches, pos, cfg, rules)
        if rules is not NO_SHARDING:
            logits = gather_over_model(logits, 1, rules, cfg.vocab_padded)
    return torch.stack(toks, 1).cpu().numpy(), torch.stack(gaps, 1).numpy()


def rank_prefill_cp():
    """[granite_prefill_cp] on this rank: granite-3-2b at full width and depth
    in float32 from seed 0 at ``CP_GRID`` under the cp_seq rules, a prefill
    of ``CP_B`` prompts of ``CP_SEQ`` tokens (every rank given them whole)
    timed, its collectives counted by op and timed (``CollectiveClock``),
    its argument bytes, its peak and the bytes held beside it (``Beside``);
    the tensor-parallel prefill of the same prompts on the same shards, its
    caches and logits beside the context-parallel ones (each rank's block);
    ``CP_NEW`` greedy steps under the tensor-parallel rules from the
    context-parallel caches; then on rank 0 the one-rank prefill and
    greedy steps of the same prompts (the others wait)."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import NO_SHARDING, make_rules, seq_block
    from repro_torch.launch.mesh import make_local_mesh

    dev = torch.device(RANK_DEVICE)
    cfg = configs.get("granite-3-2b")
    tp_rules = make_rules(cfg, make_local_mesh(*CP_GRID, device_type=RANK_DEVICE))
    rules = with_context_parallel(tp_rules)
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev, rules=tp_rules)
    toks = torch.as_tensor(serve_prompts(cfg, b=CP_B, s=CP_SEQ), dtype=torch.int64, device=dev)
    max_seq, vp = CP_SEQ + CP_NEW, cfg.vocab_padded
    arg_bytes = dryrun.argument_bytes((params, toks))
    clock = CollectiveClock(dist.get_backend())
    beside = Beside(arg_bytes)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad(), clock:
        (last, caches), prefill_s = timed(lambda: lm.prefill(params, toks, cfg, rules,
                                                            max_seq=max_seq))
    launched = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    beside.stop()
    with torch.no_grad():
        (tp_last, tp_caches), tp_prefill_s = timed(lambda: lm.prefill(params, toks, cfg, tp_rules,
                                                                      max_seq=max_seq))
        tp_last = gather_over_model(tp_last, 1, tp_rules, vp)
        names = [n for n, _ in tree_flatten_with_names(caches)]
        cache_ratio = hold_leaves(tree_leaves(caches), tree_leaves(tp_caches), names)
        tp_logit_ratio = hold_leaves([last[:, :cfg.vocab]], [tp_last[:, :cfg.vocab]], ["last"])[0]
        del tp_caches
        tokens, _ = greedy_steps(params, cfg, tp_rules, caches, last, CP_SEQ, CP_NEW)
    out = {"prefill_s": prefill_s, "tp_prefill_s": tp_prefill_s, "peak_gb": peak_gb,
           "beside": beside.bytes, "arg_bytes": arg_bytes, "by_op": clock.by_op(),
           "launched": launched, "cache_ratio": cache_ratio, "tp_logit_ratio": tp_logit_ratio,
           "tokens": tokens, "last": last[:, :cfg.vocab].cpu(), "rank": dist.get_rank(),
           "seq_block": seq_block(CP_SEQ, rules), "params_m": param_count(params) / 1e6,
           "cache_shape": tuple(tree_leaves(caches)[0].shape)}
    del params, caches, last
    free()
    if dist.get_rank() == 0:
        full = lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
        with torch.no_grad():
            one_last, one_caches = lm.prefill(full, toks, cfg, NO_SHARDING, max_seq=max_seq)
            out["one_logit_ratio"] = hold_leaves([out["last"].to(dev)],
                                                 [one_last[:, :cfg.vocab]], ["last"])[0]
            out["one_tokens"], out["one_gaps"] = greedy_steps(full, cfg, NO_SHARDING, one_caches,
                                                              one_last, CP_SEQ, CP_NEW)
        del full, one_caches, one_last
        free()
    dist.barrier()
    return out


def rank_train_cp():
    """[granite_train_cp] on this rank: ``cp_train_config()`` through
    ``trainer.train`` under the cp_seq train cell's rules at ``CP_GRID``
    (``with_context_parallel``, then ``with_fsdp``, which adds no axis at
    data 1), [granite_train]'s weights and optimizer on ``TokenStream``
    batches of ``CP_B`` x ``CP_SEQ`` (every rank given the rows whole),
    ``CP_TRAIN_STEPS`` steps: the losses, each step's seconds, the
    collectives per step by op and their seconds (``CollectiveClock``), a
    step's argument bytes (``StepArguments``), the peak and the bytes held
    beside the run (``Beside``); then on rank 0 the one-rank run's losses on
    the same batches (the others wait, their state dropped)."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import NO_SHARDING, make_rules
    from repro_torch.launch.mesh import make_local_mesh

    dev = torch.device(RANK_DEVICE)
    cfg = cp_train_config()
    mesh = make_local_mesh(*CP_GRID, device_type=RANK_DEVICE)
    rules = with_fsdp(with_context_parallel(make_rules(cfg, mesh)))
    specs = lm.param_specs(cfg, rules)
    opt = OptimizerConfig(lr=3e-4, warmup_steps=20, total_steps=TRAIN_STEPS)
    tcfg = TrainerConfig(total_steps=CP_TRAIN_STEPS, log_every=CP_TRAIN_STEPS, opt=opt)
    batches = train_batches(cfg, dev, CP_B, CP_SEQ)
    beside = Beside()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev, rules=rules)
    clock = CollectiveClock(dist.get_backend())
    at_step = []
    with clock, StepArguments() as step_args:
        params, _, history = train(
            params, lambda p, b: lm.train_loss(p, b, cfg, rules), batches, tcfg,
            hooks=[lambda step, p, m: at_step.append(clock.by_op())], param_specs=specs,
            rules=rules)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    out = {"losses": [h["loss"] for h in history], "dts": [h["dt"] for h in history],
           "peak_gb": peak_gb, "beside": beside.stop(), "launched": counts(),
           "params_m": param_count(params) / 1e6, "by_op": at_step, "rank": dist.get_rank(),
           "arg_bytes": step_args.bytes, "layers": cfg.n_layers,
           "context_parallel": rules.context_parallel, "fsdp_axes": rules.fsdp_axes}
    del params
    free()
    if dist.get_rank() == 0:
        full = lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
        _, _, one = train(full, lambda p, b: lm.train_loss(p, b, cfg, NO_SHARDING), batches, tcfg)
        out["one_rank_losses"] = [h["loss"] for h in one]
        del full
        free()
    dist.barrier()
    return out


# ---------------------------------------------------------------------------
# sharded serving (Engine(rules=), split-KV caches, the SSM's heads region)
# ---------------------------------------------------------------------------

# [sharded_serve_hold]: each case's config and (B, S, new tokens). Float32
# against the one-rank run on the card, fed the one-rank run's greedy
# tokens; caches and logits within SHARD_TOL of each leaf's (each step's)
# norm, as the CPU tests hold them (tests/test_torch_serve_tp.py). granite
# and deepseek at full width cut (SHARD_CUT layers; the prologue and
# DEEPSEEK_CUT_GROUPS MoE groups, S=8 so that T·k = 192 stays dropless and
# (2, 2)'s routing of each batch shard alone equals one rank's), gemma3 at
# full width, one group (5 layers of window 1024 and a global one), a
# prompt of one window so that the decode steps leave position 0 behind;
# mamba2, zamba2 and whisper at smoke size.
SERVE_HOLD_NEW = 8
# The int8 cache's values: within one quantization step of one rank's (the
# split sums move a value across a rounding boundary now and then); its
# scales are held by norm, and each step's logits within INT8_LOGIT_TOL of
# its one-rank norm, every argmax equal. Both sides read the same
# quantized cache, so the budget is that of a moved value, not int8's
# against float32: one value moved by a step moved granite's cut logits
# by 4.9e-5-6.4e-5 of their norm on the H100; a split-KV combine that
# drops or misweights one rank's partial moves them far more (PERF.md §6,
# the control).
INT8_STEP, INT8_LOGIT_TOL = 1, 5e-4


def serve_hold_cases():
    g = configs.get("granite-3-2b").with_overrides(n_layers=SHARD_CUT, dtype="float32")
    ds = configs.get("deepseek-v2-lite-16b")
    ds = ds.with_overrides(n_layers=ds.first_dense_layers + DEEPSEEK_CUT_GROUPS, dtype="float32")
    gm = configs.get("gemma3-12b")
    gm = gm.with_overrides(n_layers=gm.local_global_ratio + 1, dtype="float32")
    smoke = {a: configs.smoke(a).with_overrides(dtype="float32")
             for a in ("mamba2-370m", "zamba2-2.7b", "whisper-base")}
    return {"granite-3-2b": (g, 4, 8), "granite-3-2b-int8": (g.with_overrides(kv_quant="int8"), 4, 8),
            "gemma3-12b": (gm, 2, gm.window), "deepseek-v2-lite-16b": (ds, 4, 8),
            **{f"{a}-smoke": (c, 4, 8) for a, c in smoke.items()}}


def serve_steps(params, cfg, rules, prompts, enc, new, feed=None):
    """A prefill and ``new`` decode steps under ``rules`` (this rank's rows,
    fed ``feed``'s tokens, else greedy): (the caches after the prefill,
    gathered, as (name, leaf); every step's logits, gathered; the tokens
    fed; the MoE calls; the step of each MoE call, 0 the prefill). A
    collective under a mesh."""
    from repro_torch.dist.sharding import batch_rows, gather_over_model, gather_shard, local_shard

    b, s = prompts.shape
    rules, rows = batch_rows(b, rules)
    dev = params["final_norm"].device
    toks = local_shard(torch.as_tensor(prompts, dtype=torch.int64, device=dev), rows, rules)
    enc_l = None if enc is None else local_shard(torch.as_tensor(enc, device=dev), rows, rules)

    def gathered(logits):  # the vocabulary's columns, not the padding's float32 minimum
        return gather_shard(gather_over_model(logits, 1, rules, cfg.vocab_padded), rows,
                            rules)[:, :cfg.vocab]

    with torch.no_grad():
        (logits, caches), calls = capture_moe(
            lambda: lm.prefill(params, toks, cfg, rules, max_seq=s + new, enc_in=enc_l))
        full = [(n, t.clone()) for n, t in
                tree_flatten_with_names(lm.gather_caches(caches, cfg, rules, max_seq=s + new))]
        steps, fed, call_steps = [gathered(logits)], [], [0] * len(calls)
        for i in range(new):
            tok = torch.argmax(steps[-1], dim=-1) if feed is None else feed[:, i]
            fed.append(tok)
            pos = torch.full((toks.shape[0],), s + i, dtype=torch.int64, device=dev)
            (logits, caches), more = capture_moe(lambda: lm.decode_step(
                params, local_shard(tok, rows, rules), caches, pos, cfg, rules))
            calls += more
            call_steps += [i + 1] * len(more)
            steps.append(gathered(logits))
    return full, steps, torch.stack(fed, 1), calls, call_steps


def hold_caches(got, want):
    """(the largest norm ratio over the float leaves and its leaf, the int8
    values that differ from one rank's, the largest such difference), of
    two lists of (name, leaf)."""
    flips, worst_step, floats = 0, 0, ([], [], [])
    for (name, g), (_, w) in zip(got, want):
        if g.dtype == torch.int8:
            d = (g.int() - w.int()).abs()
            flips, worst_step = flips + int((d > 0).sum()), max(worst_step, int(d.max()))
        else:
            for lst, v in zip(floats, (g, w, name)):
                lst.append(v)
    return hold_leaves(*floats), flips, worst_step


def rank_serve_hold(grid):
    """[sharded_serve_hold] on this rank (the results on rank 0): per case,
    the one-rank run on rank 0, its tokens broadcast, then the sharded run
    fed them, held against it."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import NO_SHARDING, make_rules
    from repro_torch.launch.mesh import make_local_mesh

    dev = torch.device(RANK_DEVICE)
    mesh = make_local_mesh(*grid, device_type=RANK_DEVICE)
    rank0 = dist.get_rank() == 0
    out = {}
    for name, (cfg, b, s) in serve_hold_cases().items():
        t0 = time.perf_counter()
        prompts = serve_prompts(cfg, b=b, s=s)
        enc = serve_frames(cfg, b=b, s=s) if cfg.enc_dec else None
        feed = torch.empty((b, SERVE_HOLD_NEW), dtype=torch.int64, device=dev)
        if rank0:
            params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
            one = serve_steps(params, cfg, NO_SHARDING, prompts, enc, SERVE_HOLD_NEW)
            feed.copy_(one[2])
            del params
            free()
        dist.broadcast(feed, src=0)
        rules = make_rules(cfg, mesh)
        params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev, rules=rules)
        got = serve_steps(params, cfg, rules, prompts, enc, SERVE_HOLD_NEW, feed)
        del params
        free()
        if not rank0:
            continue
        flips = [(i, routing_differences(rs, xs, ro, xo[:xs.shape[0]], cfg.top_k))
                 for i, ((rs, xs), (ro, xo)) in enumerate(zip(got[3], one[3]))]
        out[name] = {"caches": hold_caches(got[0], one[0]),
                     "logits": hold_leaves(got[1], one[1], [f"step{i}" for i in range(len(got[1]))]),
                     "logit_ratios": [hold_leaves([a], [w], [""])[0] for a, w in zip(got[1], one[1])],
                     "logit_max_abs": max(float((a - w).abs().max()) for a, w in zip(got[1], one[1])),
                     "logit_scale": max(float(w.abs().max()) for w in one[1]),
                     "int8": cfg.kv_quant == "int8",
                     "moe_calls": len(got[3]), "flips": flips, "call_steps": got[4],
                     "argmax_equal_steps": sum(bool(torch.equal(torch.argmax(a, -1),
                                                                torch.argmax(w, -1)))
                                               for a, w in zip(got[1], one[1])),
                     "steps": len(got[1]), "shape": (b, s, SERVE_HOLD_NEW), "layers": cfg.n_layers,
                     "d_model": cfg.d_model, "seconds": time.perf_counter() - t0}
    return out if rank0 else {}


def rank_serve_tp(arch, grid):
    """[granite_serve_tp] / [zamba2_serve_tp] (at the (1, 2) grid) and
    [granite_serve_uneven] / [whisper_serve_uneven] (at ``UNEVEN_GRID``) on
    this rank: ``cfg`` at full width and depth in float32 from seed 0, this
    rank's shard (and its block of the heads), through
    ``Engine(rules=).generate`` at the serving shape (an encoder-decoder
    model with ``serve_frames``' frames) after a warm-up, with
    every kernel count set to 0 just before it and read just after (and
    the decode kernel's head counts); then a prefill and each decode step
    timed by hand, the collectives' calls and seconds counted, the prefill's
    and the first decode step's argument bytes, the bytes held beside the
    ``generate`` (``Beside``); on rank 0 of zamba2 one
    real decode step's ``ssd_decode`` inputs (the rank's heads)."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import make_rules
    from repro_torch.launch.mesh import make_local_mesh

    from repro_torch.models.attention import head_block

    dev = torch.device(RANK_DEVICE)
    cfg = configs.get(arch)
    rules = make_rules(cfg, make_local_mesh(*grid, device_type=RANK_DEVICE))
    params, init_s = timed(lambda: lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev,
                                                  rules=rules))
    prompts = serve_prompts(cfg)
    frames = serve_frames(cfg) if cfg.enc_dec else None
    enc = enc_on(frames, dev)
    Engine(params, cfg, ServeConfig(max_new_tokens=2), device=dev, rules=rules).generate(
        prompts, enc=frames)
    eng = Engine(params, cfg, ServeConfig(max_new_tokens=SERVE_NEW), device=dev, rules=rules)
    heads, orig = [], ops.ssd_decode

    def spy(state, *args):
        heads.append(state.shape[1])
        return orig(state, *args)

    beside = Beside(dryrun.argument_bytes(params))
    torch.cuda.reset_peak_memory_stats()
    ops.ssd_decode = spy
    try:
        reset_counts()
        out, wall = timed(lambda: eng.generate(prompts, enc=frames))
        launched = counts()
    finally:
        ops.ssd_decode = orig
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    beside.stop()

    clock = CollectiveClock(dist.get_backend())
    b, s = prompts.shape
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    arg_bytes = {"prefill": dryrun.argument_bytes((params, toks, enc))}
    vp = cfg.vocab_padded

    with torch.no_grad(), clock:
        (logits, caches), prefill_s = timed(lambda: lm.prefill(params, toks, cfg, rules,
                                                                max_seq=s + SERVE_NEW, enc_in=enc))
        tok, steps, coll = torch.argmax(gather_over_model(logits, 1, rules, vp), -1), [], []
        for i in range(SERVE_NEW):
            before = (clock.seconds(), clock.calls)
            pos = torch.full((b,), s + i, device=dev)
            if i == 0:
                arg_bytes["decode"] = dryrun.argument_bytes((params, tok, caches, pos))
            (logits, caches), t = timed(lambda: lm.decode_step(params, tok, caches, pos, cfg,
                                                               rules))
            tok = torch.argmax(gather_over_model(logits, 1, rules, vp), -1)
            after = (clock.seconds(), clock.calls)
            steps.append(t)
            coll.append((after[0] - before[0], after[1] - before[1]))
    inputs = None
    if arch == "zamba2-2.7b":  # every rank: the step is a collective
        calls = []

        def grab(*args):
            calls.append([a.clone() for a in args])
            return orig(*args)

        ops.ssd_decode = grab
        try:
            with torch.no_grad():
                logits, caches = lm.prefill(params, toks, cfg, rules, max_seq=s + 1)
                lm.decode_step(params, torch.argmax(gather_over_model(logits, 1, rules, vp), -1),
                               caches, torch.full((b,), s, device=dev), cfg, rules)
        finally:
            ops.ssd_decode = orig
        inputs = [a.cpu() for a in calls[0]] if dist.get_rank() == 0 else None
    return {"tokens": out, "wall": wall, "launched": launched, "heads": sorted(set(heads)),
            "peak_gb": peak_gb, "beside": beside.bytes, "init_s": init_s,
            "params_m": param_count(params) / 1e6, "prefill_s": prefill_s, "steps": steps,
            "collectives": coll, "ssd_inputs": inputs, "rank": dist.get_rank(),
            "arg_bytes": arg_bytes, "head_block": head_block(cfg.n_heads, rules)}


def rank_ssd_device(inputs):
    """[ssd_decode_device_time] in a process of its own: the decode kernel's
    device time on ``inputs`` (CPU tensors)."""
    args = [a.to(RANK_DEVICE) for a in inputs]
    return {"device_ms": device_ms(lambda: sd.launch(*args), "ssd_decode_heads")}


# ---------------------------------------------------------------------------
# the batched estimator and the engines sharded over the data ranks
# ---------------------------------------------------------------------------

# [fit_batch_data_sharded] at LINGAM_GRIDS (in the two- and four-rank
# sets), [engine_data_sharded] at LINGAM_ENGINE_GRID; [lingam_sharded_jobs]
# prints their seconds beside LINGAM_JOBS_S without failing on it (the
# host's speed varies ~2x between calls).
LINGAM_GRIDS, LINGAM_ENGINE_GRID = ((2, 1), (4, 1)), (2, 1)
LINGAM_JOBS, LINGAM_JOBS_S = ("fit_batch_sharded", "engine_sharded"), 30
BATCH_FIELDS = ("orders", "comparisons", "rounds", "converged", "b", "noise_var")
# The update kernel's fit mode and kernel #2, one launch each per scan
# iteration of a dispatch: p_pad - 1 (127 for the E. coli bucket).
FIT_KERNELS = ("fused_score_batch", "rank1_update")


def batch_arrays(res) -> dict:
    """A ``BatchFitResult``'s fields as host arrays."""
    return {k: getattr(res, k).cpu().numpy() for k in BATCH_FIELDS}


def fit_differences(tag: str, got: dict, want: dict) -> list:
    """"tag:field@index" of the first entry of each field of ``got`` that
    differs from ``want`` bit for bit (shapes and dtypes too)."""
    out = []
    for k in BATCH_FIELDS:
        g, w = got[k], want[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            out.append(f"{tag}:{k}@{g.shape}{g.dtype}")
        elif not np.array_equal(g, w):
            out.append(f"{tag}:{k}@{tuple(int(i) for i in np.argwhere(g != w)[0])}")
    return out


def lingam_cases(grid) -> list:
    """(tag, requests, bucket, config) of ``[fit_batch_data_sharded]`` at
    ``grid``: the ragged E. coli bucket dense under ``hopper_fused``, and at
    2 x 1 also the two iJR904-size requests."""
    dense = ParaLiNGAMConfig(score_backend="hopper_fused")
    cases = [("ecoli_dense", ecoli_requests(), ECOLI_BUCKET, dense)]
    if grid == LINGAM_ENGINE_GRID:
        cases.append(("ijr_dense", ijr_requests(), IJR_BUCKET, dense))
    return cases


def same_fit(f, w) -> bool:
    """Two ``LingamFit``s equal bit for bit."""
    return (f.order == w.order and np.array_equal(f.b, w.b)
            and np.array_equal(f.noise_var, w.noise_var) and f.comparisons == w.comparisons
            and f.rounds == w.rounds and f.converged == w.converged)


def unpadded_fits(raw, arrays: dict) -> list:
    """Each request's ``LingamFit`` from a bucket's host results."""
    from repro_torch.serve.lingam_engine import unpad

    return unpad(raw, [arrays[k] for k in ("orders", "comparisons", "b", "noise_var", "rounds",
                                           "converged")])


def rank_fit_batch_sharded(grid, want):
    """[fit_batch_data_sharded] on this rank: ``fit_batch(rules=)`` of each
    ``lingam_cases`` bucket (dense ones after a warm-up dispatch), timed,
    its launches and the gather counted, every field held bit for bit
    against the one-rank ``want[tag]``; at 4 x 1 also 6 E. coli requests
    through ``dispatch_bucket(rules=)``, padded to 8 (the last rank's rows
    all dead), each fit against its row of the one-rank bucket."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import make_rules, row_block
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.serve.lingam_engine import dispatch_bucket

    dev = torch.device(RANK_DEVICE)
    rules = make_rules(ParaLiNGAMConfig(), make_local_mesh(*grid, device_type=RANK_DEVICE))
    cases = []

    def timed_case(tag, b, run):
        reset_counts()
        clock = CollectiveClock(dist.get_backend())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with clock:
            got = run()
        seconds = time.perf_counter() - t0
        gathers = [r for r in clock.records if r["op"] == "all-gather"]
        cases.append({"tag": tag, "B": b, "rows": row_block(b, rules)[1:], "seconds": seconds,
                      "launched": counts(), "gathers": len(gathers),
                      "gather_bytes": sum(r["out_bytes"] for r in gathers),
                      "gather_s": clock.by_op().get("all-gather", (0, 0.0))[1]})
        return got

    for tag, raw, bucket, cfg in lingam_cases(grid):
        xs, mask, nv, _ = pack_bucket(raw, *bucket)

        def run(cfg=cfg, xs=xs, mask=mask, nv=nv):
            return batch_arrays(fit_batch(xs, cfg, n_valid=nv, mask=mask, rules=rules,
                                          device=dev))

        if not cfg.threshold:
            run()  # this rank's first dispatch of the bucket
        got = timed_case(tag, len(raw), run)
        cases[-1]["differ"] = fit_differences(tag, got, want[tag][0])
    if grid != LINGAM_ENGINE_GRID:
        raw = ecoli_requests()[:6]
        fits = timed_case("ecoli_6_of_8", 8, lambda: dispatch_bucket(
            raw, *ECOLI_BUCKET, ParaLiNGAMConfig(score_backend="hopper_fused"), SERVE_CFG, rules,
            device=dev))
        ones = unpadded_fits(raw, want["ecoli_dense"][0])
        cases[-1]["differ"] = [f"ecoli_6_of_8:{i}" for i, (f, w) in enumerate(zip(fits, ones))
                               if not same_fit(f, w)]
    return {"rank": dist.get_rank(), "cases": cases}


def rank_engine_sharded(grid, want):
    """[engine_data_sharded] on this rank: ``AsyncLingamEngine(rules=)``
    built alike on every rank with [engine]'s buckets pre-warmed at every
    batch count; the leader serves the 10 ``serve_mixed`` requests from 3
    submitter threads over 2 replicas, each fit held bit for bit against
    the one-rank engine's (``want``); a follower's submit must raise, and
    its ``close()`` returns after the leader's. Launches counted from the
    end of construction (a barrier) on."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import make_rules
    from repro_torch.launch.mesh import make_local_mesh

    dev = torch.device(RANK_DEVICE)
    rules = make_rules(ParaLiNGAMConfig(), make_local_mesh(*grid, device_type=RANK_DEVICE))
    requests = ecoli_requests() + ijr_requests()
    t0 = time.perf_counter()
    eng = AsyncLingamEngine(
        ParaLiNGAMConfig(), SERVE_CFG, rules, batch_cfg=BatchingConfig(
            max_batch=8, max_queue=64, flush_interval=1.0),
        replicas=2, prewarm=[ECOLI, SLICE], device=dev)
    out = {"rank": dist.get_rank(), "prewarm_s": time.perf_counter() - t0,
           "prewarm": eng.stats()["prewarm"]}
    reset_counts()
    paralingam.reset_dispatch_stats()
    dist.barrier()
    if dist.get_rank() != 0:
        try:
            eng.submit(requests[0])
            out["submit_refused"] = False
        except ValueError:
            out["submit_refused"] = True
        eng.close()
        out.update(launched=counts(), ended=not eng._follower.is_alive())
        return out
    try:
        results, wall = serve_round(eng, requests)
        launched, st = counts(), eng.stats()
        st["rank1_update"] = paralingam.dispatch_stats_snapshot()["rank1_update"]
    finally:
        eng.close(timeout=120)
    out.update(wall=wall, launched=launched, stats=st,
               differ=[i for i, (f, w) in enumerate(zip(results, want)) if not same_fit(f, w)])
    return out


def report_fit_batch_sharded(gpu, grid, ranks, backend, cards, want):
    """[fit_batch_data_sharded]: one line per case, each rank's numbers."""
    for i, case in enumerate(ranks[0]["cases"]):
        rows = [r["cases"][i] for r in ranks]
        iterations = (IJR_BUCKET if case["tag"].startswith("ijr") else ECOLI_BUCKET)[0] - 1
        # The threshold machine scores through torch ops, not kernel #2.
        want_launches = [0 if "threshold" in case["tag"] else iterations, iterations]
        launched = [[c["launched"][k] for k in FIT_KERNELS] for c in rows]
        say("fit_batch_data_sharded", grid=f"{grid[0]}x{grid[1]}", case=case["tag"],
            B=case["B"], backend=backend, cards=cards,
            rows_per_rank=",".join(f"{c['rows'][0]}-{c['rows'][1]}" for c in rows),
            seconds_per_dispatch=",".join(f"{c['seconds']:.4f}" for c in rows),
            one_rank_s=f"{want[case['tag']][1]:.4f}" if case["tag"] in want else "none",
            fused_score_batch_launches=",".join(str(n[0]) for n in launched),
            update_launches=",".join(str(n[1]) for n in launched),
            gathers=",".join(str(c["gathers"]) for c in rows),
            gather_bytes=",".join(str(c["gather_bytes"]) for c in rows),
            gather_s=",".join(f"{c['gather_s']:.4f}" for c in rows),
            equal_to_one_rank=f"{sum(not c['differ'] for c in rows)}/{len(rows)}",
            first_differences=",".join(d for c in rows for d in c["differ"][:2]) or "none",
            gpu=f"'{gpu}'")
        check(all(not c["differ"] for c in rows),
              f"{grid} {case['tag']}: a rank's results differ from one rank's")
        check(all(n == want_launches for n in launched),
              f"{grid} {case['tag']}: launches {launched}, want {want_launches}")
        check(all(c["gathers"] == 1 for c in rows), f"{grid} {case['tag']}: not one gather")


def report_engine_sharded(gpu, grid, ranks, backend, cards):
    """[engine_data_sharded]: the leader's round and every rank's launches."""
    r0, followers = ranks[0], ranks[1:]
    st = r0["stats"]
    want = sum(b["dispatches"] * (bucket[0] - 1) for bucket, b in st["buckets"].items())
    launched = [[r["launched"][k] for k in FIT_KERNELS] for r in ranks]
    say("engine_data_sharded", grid=f"{grid[0]}x{grid[1]}", backend=backend, cards=cards,
        requests=st["admitted"], delivered=st["delivered"], dispatches=st["dispatches"],
        wall_s=f"{r0['wall']:.4f}", requests_per_s=f"{st['delivered'] / r0['wall']:.3f}",
        prewarm_s=",".join(f"{r['prewarm_s']:.2f}" for r in ranks),
        prewarm_executables=r0["prewarm"]["executables"],
        fused_score_batch_launches=",".join(str(n[0]) for n in launched),
        update_launches=",".join(str(n[1]) for n in launched), want_launches=want,
        kernel_bypass=st["kernel_bypass"],
        fits_equal_to_one_rank_engine=f"{10 - len(r0['differ'])}/10",
        follower_submit_refused=all(r["submit_refused"] for r in followers),
        followers_ended=all(r["ended"] for r in followers), gpu=f"'{gpu}'")
    check(st["delivered"] == st["admitted"] == 10, f"delivered {st['delivered']} of 10")
    check(st["kernel_bypass"] == 0, f"kernel_bypass={st['kernel_bypass']}")
    check(not r0["differ"], f"served fits {r0['differ']} differ from the one-rank engine's")
    check(all(n == [want] * 2 for n in launched) and st["rank1_update"] == want,
          f"launches {launched} (dispatch_stats {st['rank1_update']}), want {want} of each")
    check(all(r["submit_refused"] and r["ended"] for r in followers),
          "a follower took a submit or did not end")


RANK_JOBS = {"tp_train": rank_tp_train, "sharded_hold": rank_sharded_hold,
             "ep_hold": rank_ep_hold, "serve_hold": rank_serve_hold, "serve_tp": rank_serve_tp,
             "ssd_device": rank_ssd_device, "fsdp_hold": rank_fsdp_hold,
             "fsdp_train": rank_fsdp_train, "prefill_cp": rank_prefill_cp,
             "train_cp": rank_train_cp, "cp_hold": rank_cp_hold,
             "fit_batch_sharded": rank_fit_batch_sharded, "engine_sharded": rank_engine_sharded}


def report_granite_train_tp(gpu, grid, ranks, backend, cards, one_rank_losses):
    """[granite_train_tp]: held against ``[granite_train]``'s losses."""
    r0 = ranks[0]
    for r in ranks:
        check(not any(r["launched"].values()), f"granite_train_tp: kernels launched {r['launched']}")
        check(r["losses"] == r0["losses"], "granite_train_tp: the ranks' losses differ")
    losses, dts = r0["losses"], r0["dts"]
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
          f"granite_train_tp: losses {losses}")
    diffs = [abs(a - b) for a, b in zip(losses, one_rank_losses)]
    check(max(diffs) <= BF16_LOSS_ATOL, f"granite_train_tp: losses {losses} against one rank's "
          f"{one_rank_losses}")
    steady = sum(dts[1:]) / (len(dts) - 1)
    coll = r0["collective_s"]
    coll_steady = (coll[-1][0] - coll[0][0]) / (len(coll) - 1)
    tokens = TRAIN_B * TRAIN_SEQ
    say("granite_train_tp", arch="granite-3-2b", preset="full", grid="x".join(map(str, grid)),
        backend=backend, cards=cards, ranks=len(ranks), params_m_per_rank=f"{r0['params_m']:.1f}",
        batch=TRAIN_B, seq=TRAIN_SEQ, steps=TRAIN_STEPS, kernel_launches=0,
        first_step_s=f"{dts[0]:.4f}", step_s=",".join(f"{d:.4f}" for d in dts[1:]),
        tok_per_s=f"{tokens / steady:.1f}",
        peak_gb_per_rank=",".join(f"{r['peak_gb']:.3f}" for r in ranks),
        collective_s_per_step=f"{coll_steady:.4f}",
        collective_share=f"{coll_steady / steady:.3f}",
        collective_calls_per_step=(coll[-1][1] - coll[0][1]) // (len(coll) - 1),
        losses=",".join(f"{v:.4f}" for v in losses),
        one_rank_losses=",".join(f"{v:.4f}" for v in one_rank_losses),
        loss_max_abs_diff=f"{max(diffs):.3e}", allowed=BF16_LOSS_ATOL,
        job_s=f"{r0['job_s']:.1f}", gpu=f"'{gpu}'")


def per_step_by_op(by_op: list) -> dict:
    """op -> (calls, seconds) per step, from ``CollectiveClock.by_op()``
    read at the end of each step: the steps after the first, averaged."""
    first, last, steps = by_op[0], by_op[-1], len(by_op) - 1
    return {op: ((n - first.get(op, (0, 0.0))[0]) // steps,
                 (t - first.get(op, (0, 0.0))[1]) / steps) for op, (n, t) in last.items()}


def by_op_text(by_op: dict) -> str:
    return ";".join(f"{op}:{n}:{t:.4f}s" for op, (n, t) in sorted(by_op.items()))


def report_granite_train_fsdp(gpu, ranks, backend, cards, one_rank_losses, tp_ranks):
    """[granite_train_fsdp]: held against ``[granite_train]``'s losses; the
    GB per rank beside ``[granite_train_tp]``'s."""
    r0 = ranks[0]
    for r in ranks:
        check(not any(r["launched"].values()),
              f"granite_train_fsdp: kernels launched {r['launched']}")
        check(r["losses"] == r0["losses"], "granite_train_fsdp: the ranks' losses differ")
    losses, dts = r0["losses"], r0["dts"]
    check(len(losses) == FSDP_STEPS and all(math.isfinite(v) for v in losses),
          f"granite_train_fsdp: losses {losses}")
    diffs = [abs(a - b) for a, b in zip(losses, one_rank_losses)]
    check(max(diffs) <= BF16_LOSS_ATOL, f"granite_train_fsdp: losses {losses} against one "
          f"rank's {one_rank_losses[:FSDP_STEPS]}")
    steady = sum(dts[1:]) / (len(dts) - 1)
    per_step = per_step_by_op(r0["by_op"])
    coll_s = sum(t for _, t in per_step.values())
    say("granite_train_fsdp", arch="granite-3-2b", preset="full",
        grid="x".join(map(str, FSDP_GRID)), fsdp_axes=",".join(r0["fsdp_axes"]),
        backend=backend, cards=cards, ranks=len(ranks), params_m_per_rank=f"{r0['params_m']:.1f}",
        batch=TRAIN_B, seq=TRAIN_SEQ, steps=FSDP_STEPS, kernel_launches=0,
        first_step_s=f"{dts[0]:.4f}", step_s=",".join(f"{d:.4f}" for d in dts[1:]),
        tok_per_s=f"{TRAIN_B * TRAIN_SEQ / steady:.1f}",
        arg_gb_per_rank=",".join(f"{r['arg_bytes'] / 1e9:.3f}" for r in ranks),
        peak_gb_per_rank=",".join(f"{r['peak_gb']:.3f}" for r in ranks),
        tp_peak_gb_per_rank=",".join(f"{r['peak_gb']:.3f}" for r in tp_ranks),
        tp_arg_gb_per_rank=",".join(f"{r['arg_bytes'] / 1e9:.3f}" for r in tp_ranks),
        collective_calls_per_step=sum(n for n, _ in per_step.values()),
        collective_s_per_step=f"{coll_s:.4f}", collective_share=f"{coll_s / steady:.3f}",
        by_op_per_step=by_op_text(per_step), losses=",".join(f"{v:.4f}" for v in losses),
        one_rank_losses=",".join(f"{v:.4f}" for v in one_rank_losses[:FSDP_STEPS]),
        loss_max_abs_diff=f"{max(diffs):.3e}", allowed=BF16_LOSS_ATOL,
        job_s=f"{r0['job_s']:.1f}", gpu=f"'{gpu}'")


def report_train_fsdp_hold(gpu, grid, ranks, backend, cards):
    """[train_fsdp_hold] at ``grid``: the loss against the same grid's
    without FSDP, then against the one-rank run on the card."""
    r0 = ranks[0]
    arch = r0["arch"]
    tag = f"train_fsdp_hold {arch} {grid}"
    check(all(r["loss"] == r0["loss"] for r in ranks), f"{tag}: the ranks' losses differ")
    check(all(r["loss"] == r["plain_loss"] for r in ranks),
          f"{tag}: losses {[r['loss'] for r in ranks]} against the grid's without FSDP "
          f"{[r['plain_loss'] for r in ranks]}")
    dloss = abs(r0["loss"] - r0["one_loss"]) / abs(r0["one_loss"])
    g_ratio, g_leaf = r0["grad_ratio"]
    p_ratio, p_leaf = r0["param_ratio"]
    check(dloss <= SHARD_TOL, f"{tag}: loss {r0['loss']} against one rank's {r0['one_loss']}")
    check(g_ratio <= SHARD_TOL, f"{tag}: gradient of {g_leaf} {g_ratio:.3e} of its norm")
    check(p_ratio <= SHARD_TOL, f"{tag}: parameter {p_leaf} {p_ratio:.3e} of its norm")
    check(r0["fsdp_leaves"] > 0 and r0["moments_sliced"] == 0,
          f"{tag}: {r0['fsdp_leaves']} FSDP leaves, {r0['moments_sliced']} ZeRO-1 slices")
    full = configs.get(arch)
    say("train_fsdp_hold", arch=full.name, reduced=f"n_layers {full.n_layers}->{r0['layers']}, "
        f"batch {TRAIN_B}->{SHARD_B}", grid="x".join(map(str, grid)), backend=backend,
        cards=cards, rules=r0["rules"], fsdp_leaves=r0["fsdp_leaves"],
        zero1_moment_slices=r0["moments_sliced"], params_m=f"{r0['params_m']:.1f}",
        seq=TRAIN_SEQ, dtype="float32", loss=f"{r0['loss']:.6f}",
        plain_loss_equal=r0["loss"] == r0["plain_loss"], one_rank_loss=f"{r0['one_loss']:.6f}",
        loss_rel_diff=f"{dloss:.3e}", grad_norm_ratio_max=f"{g_ratio:.3e}",
        grad_worst_leaf=g_leaf, param_norm_ratio_max=f"{p_ratio:.3e}", param_worst_leaf=p_leaf,
        allowed=SHARD_TOL, leaves=r0["leaves"], one_rank_local_capacity=r0["local_capacity"],
        routing_flips=r0["routing_flips"], sharded_grads_s=f"{r0['seconds']:.3f}",
        peak_gb_rank0=f"{r0['peak_gb']:.3f}", job_s=f"{r0['job_s']:.1f}", gpu=f"'{gpu}'")


def report_train_sharded_hold(gpu, grid, ranks, backend, cards):
    """[train_sharded_hold] at ``grid``: against the one-rank run on the card."""
    r0 = ranks[0]
    arch = r0["arch"]
    full = configs.get(arch)
    check(all(r["loss"] == r0["loss"] for r in ranks), "train_sharded_hold: ranks' losses differ")
    dloss = abs(r0["loss"] - r0["one_loss"]) / abs(r0["one_loss"])
    g_ratio, g_leaf = r0["grad_ratio"]
    share, b_ratio, b_allowed, b_floor, b_leaf = r0["grad_beyond"]
    check(dloss <= SHARD_TOL, f"train_sharded_hold {arch} {grid}: loss {r0['loss']} against "
          f"{r0['one_loss']}")
    check(share <= 1.0, f"train_sharded_hold {arch} {grid}: gradient of {b_leaf} {b_ratio:.3e} "
          f"of its norm from one rank's, allowed {b_allowed:.3e} (its reordering floor "
          f"{b_floor:.3e})")
    check(r0["param_excess"] <= 0, f"train_sharded_hold {arch} {grid}: adamw_update's parameters "
          f"beyond rtol {OPT_RTOL}, atol {OPT_ATOL} of one rank's")
    check((r0["moments_sliced"] > 0) == (grid[0] > 1),
          f"train_sharded_hold {arch} {grid}: {r0['moments_sliced']} ZeRO-1 moment slices")
    reduced = (f"n_layers {full.n_layers}->{r0['layers']}, " if r0["layers"] != full.n_layers
               else "") + f"batch {TRAIN_B}->{SHARD_B}"
    say("train_sharded_hold", arch=full.name, reduced=reduced, grid="x".join(map(str, grid)),
        backend=backend, cards=cards, zero1=grid[0] > 1, rules=r0["rules"],
        params_m=f"{r0['params_m']:.1f}", seq=TRAIN_SEQ, dtype="float32",
        loss=f"{r0['loss']:.6f}", one_rank_loss=f"{r0['one_loss']:.6f}",
        loss_rel_diff=f"{dloss:.3e}", grad_norm_ratio_max=f"{g_ratio:.3e}", grad_worst_leaf=g_leaf,
        leaves=r0["leaves"], allowed=SHARD_TOL,
        reorder_floor_max=f"{r0['reorder_floor_max']:.3e}", closest_to_bound_leaf=b_leaf,
        closest_ratio=f"{b_ratio:.3e}", closest_allowed=f"{b_allowed:.3e}",
        zero1_moment_slices=r0["moments_sliced"],
        adamw_max_abs_diff=f"{r0['param_max_abs_diff']:.3e}", adamw_rtol=OPT_RTOL,
        adamw_atol=OPT_ATOL, sharded_grads_s=f"{r0['seconds']:.3f}",
        peak_gb_rank0=f"{r0['peak_gb']:.3f}", job_s=f"{r0['job_s']:.1f}", gpu=f"'{gpu}'")


def report_granite_prefill_cp(gpu, ranks, backend, cards):
    """[granite_prefill_cp]: every rank's caches and last logits against the
    tensor-parallel prefill's, rank 0's logits against the one-rank
    prefill's, the tokens decoded from its caches against the one-rank
    run's (equal, or departing at a ``GAP_TOL`` near-tie)."""
    tag, r0 = "granite_prefill_cp", ranks[0]
    for r in ranks:
        check(not any(r["launched"].values()), f"{tag}: kernels launched {r['launched']}")
        check(np.array_equal(r["tokens"], r0["tokens"]), f"{tag}: the ranks' tokens differ")
        check(r["cache_ratio"][0] <= SHARD_TOL, f"{tag}: rank {r['rank']}'s caches "
              f"{r['cache_ratio'][0]:.3e} ({r['cache_ratio'][1]}) of the tensor-parallel norm")
        check(r["tp_logit_ratio"] <= SHARD_TOL,
              f"{tag}: logits {r['tp_logit_ratio']:.3e} of the tensor-parallel prefill's norm")
    check(r0["one_logit_ratio"] <= SHARD_TOL,
          f"{tag}: logits {r0['one_logit_ratio']:.3e} of the one-rank prefill's norm")
    out, want, gaps = r0["tokens"], r0["one_tokens"], r0["one_gaps"]
    same = 0
    for row in range(out.shape[0]):
        if np.array_equal(out[row], want[row]):
            same += 1
            continue
        k = int(np.flatnonzero(out[row] != want[row])[0])
        gap = float(gaps[row, k])
        say("token_departure", case=tag, row=row, step=k, sharded_token=int(out[row, k]),
            one_rank_token=int(want[row, k]), one_rank_top2_gap=f"{gap:.3e}", allowed=GAP_TOL,
            near_tie=gap <= GAP_TOL)
        check(gap <= GAP_TOL, f"{tag}: sequence {row} departs from one rank's at step {k} "
              "beyond a near-tie")
    coll = r0["by_op"]
    coll_s = sum(t for _, t in coll.values())
    say(tag, arch="granite-3-2b", layers=configs.get("granite-3-2b").n_layers, dtype="float32",
        grid="x".join(map(str, CP_GRID)), backend=backend, cards=cards, ranks=len(ranks),
        context_parallel=True, batch=CP_B, prompt_len=CP_SEQ,
        seq_blocks=",".join(f"{lo}-{hi}" for lo, hi in (r["seq_block"] for r in ranks)),
        params_m_per_rank=f"{r0['params_m']:.1f}", kernel_launches=0,
        prefill_s=f"{r0['prefill_s']:.4f}", tp_prefill_s=f"{r0['tp_prefill_s']:.4f}",
        collectives=sum(n for n, _ in coll.values()), collective_s=f"{coll_s:.4f}",
        collective_share=f"{coll_s / r0['prefill_s']:.3f}", by_op=by_op_text(coll),
        arg_gb_per_rank=",".join(f"{r['arg_bytes'] / 1e9:.3f}" for r in ranks),
        peak_gb_per_rank=",".join(f"{r['peak_gb']:.3f}" for r in ranks),
        cache_shape_per_rank="x".join(map(str, r0["cache_shape"])),
        cache_norm_ratio_max=f"{max(r['cache_ratio'][0] for r in ranks):.3e}",
        tp_logit_norm_ratio=f"{max(r['tp_logit_ratio'] for r in ranks):.3e}",
        one_rank_logit_norm_ratio=f"{r0['one_logit_ratio']:.3e}", allowed=SHARD_TOL,
        new_tokens=CP_NEW, decoded_under="tensor-parallel rules",
        rows_equal_to_one_rank=f"{same}/{out.shape[0]}", sample=",".join(map(str, out[0])),
        job_s=f"{r0['job_s']:.1f}", gpu=f"'{gpu}'")


def report_granite_train_cp(gpu, ranks, backend, cards):
    """[granite_train_cp]: held against the one-rank run's losses on the
    same batches."""
    tag, r0 = "granite_train_cp", ranks[0]
    for r in ranks:
        check(not any(r["launched"].values()), f"{tag}: kernels launched {r['launched']}")
        check(r["losses"] == r0["losses"], f"{tag}: the ranks' losses differ")
    losses, want, dts = r0["losses"], r0["one_rank_losses"], r0["dts"]
    check(len(losses) == CP_TRAIN_STEPS and all(math.isfinite(v) for v in losses),
          f"{tag}: losses {losses}")
    diffs = [abs(a - b) for a, b in zip(losses, want)]
    check(max(diffs) <= BF16_LOSS_ATOL, f"{tag}: losses {losses} against one rank's {want}")
    steady = sum(dts[1:]) / (len(dts) - 1)
    per_step = per_step_by_op(r0["by_op"])
    coll_s = sum(t for _, t in per_step.values())
    full = configs.get("granite-3-2b")
    say(tag, arch=full.name, preset="full",
        reduced=(f"n_layers {full.n_layers}->{r0['layers']}" if r0["layers"] != full.n_layers
                 else "none"), grid="x".join(map(str, CP_GRID)), backend=backend, cards=cards,
        ranks=len(ranks), context_parallel=r0["context_parallel"],
        fsdp_axes=",".join(r0["fsdp_axes"]) or "none", params_m_per_rank=f"{r0['params_m']:.1f}",
        batch=CP_B, seq=CP_SEQ, steps=CP_TRAIN_STEPS, kernel_launches=0,
        first_step_s=f"{dts[0]:.4f}", step_s=",".join(f"{d:.4f}" for d in dts[1:]),
        tok_per_s=f"{CP_B * CP_SEQ / steady:.1f}",
        arg_gb_per_rank=",".join(f"{r['arg_bytes'] / 1e9:.3f}" for r in ranks),
        peak_gb_per_rank=",".join(f"{r['peak_gb']:.3f}" for r in ranks),
        collective_calls_per_step=sum(n for n, _ in per_step.values()),
        collective_s_per_step=f"{coll_s:.4f}", collective_share=f"{coll_s / steady:.3f}",
        by_op_per_step=by_op_text(per_step), losses=",".join(f"{v:.4f}" for v in losses),
        one_rank_losses=",".join(f"{v:.4f}" for v in want),
        loss_max_abs_diff=f"{max(diffs):.3e}", allowed=BF16_LOSS_ATOL,
        job_s=f"{r0['job_s']:.1f}", gpu=f"'{gpu}'")


def report_train_cp_hold(gpu, grid, ranks, backend, cards):
    """[train_cp_hold] at ``grid``: against the one-rank run on the card."""
    r0 = ranks[0]
    arch = r0["arch"]
    tag = f"train_cp_hold {arch} {grid}"
    check(all(r["loss"] == r0["loss"] for r in ranks), f"{tag}: the ranks' losses differ")
    check(r0["context_parallel"], f"{tag}: not under context parallelism")
    dloss = abs(r0["loss"] - r0["one_loss"]) / abs(r0["one_loss"])
    g_ratio, g_leaf = r0["grad_ratio"]
    p_ratio, p_leaf = r0["param_ratio"]
    check(dloss <= SHARD_TOL, f"{tag}: loss {r0['loss']} against one rank's {r0['one_loss']}")
    check(g_ratio <= SHARD_TOL, f"{tag}: gradient of {g_leaf} {g_ratio:.3e} of its norm")
    check(p_ratio <= SHARD_TOL, f"{tag}: parameter {p_leaf} {p_ratio:.3e} of its norm")
    check((r0["fsdp_leaves"] > 0) == (grid[0] > 1) and r0["moments_sliced"] == 0,
          f"{tag}: {r0['fsdp_leaves']} FSDP leaves, {r0['moments_sliced']} ZeRO-1 slices")
    full, cfg = configs.get(arch), cp_hold_config(arch)
    reduced = "".join(f"{f} {getattr(full, f)}->{getattr(cfg, f)}, "
                      for f in ("n_layers", "d_model", "d_ff", "window", "vocab")
                      if getattr(cfg, f) != getattr(full, f)) + f"batch {TRAIN_B}->{SHARD_B}"
    say("train_cp_hold", arch=full.name, reduced=reduced, grid="x".join(map(str, grid)),
        backend=backend, cards=cards, rules=r0["rules"], context_parallel=True,
        fsdp_axes=",".join(r0["fsdp_axes"]) or "none", fsdp_leaves=r0["fsdp_leaves"],
        params_m=f"{r0['params_m']:.1f}", seq=TRAIN_SEQ, dtype="float32",
        loss=f"{r0['loss']:.6f}", one_rank_loss=f"{r0['one_loss']:.6f}",
        loss_rel_diff=f"{dloss:.3e}", grad_norm_ratio_max=f"{g_ratio:.3e}",
        grad_worst_leaf=g_leaf, param_norm_ratio_max=f"{p_ratio:.3e}", param_worst_leaf=p_leaf,
        allowed=SHARD_TOL, leaves=r0["leaves"], one_rank_local_capacity=r0["local_capacity"],
        routing_flips=r0["routing_flips"], sharded_grads_s=f"{r0['seconds']:.3f}",
        one_rank_turns_s=f"{r0['turns_s']:.3f}", peak_gb_rank0=f"{r0['peak_gb']:.3f}",
        job_s=f"{r0['job_s']:.1f}", gpu=f"'{gpu}'")


def report_deepseek_ep_hold(gpu, grid, ranks, backend, cards):
    """[deepseek_ep_hold] at ``grid``: the routing, then the loss and the
    gathered gradients, against the one-rank run on the card."""
    full = configs.get("deepseek-v2-lite-16b")
    r0 = ranks[0]
    tag = f"deepseek_ep_hold_{grid[0]}x{grid[1]}"
    ties = sum(len(hold_flips(tag, call, diffs)) for call, diffs in r0["flips"])
    check(all(r["loss"] == r0["loss"] for r in ranks), "deepseek_ep_hold: ranks' losses differ")
    dloss = abs(r0["loss"] - r0["one_loss"]) / abs(r0["one_loss"])
    g_ratio, g_leaf = r0["grad_ratio"]
    if not ties:  # the same routing: the same function, held in float32
        check(dloss <= SHARD_TOL and g_ratio <= SHARD_TOL,
              f"{tag}: loss {r0['loss']} against {r0['one_loss']}, gradients "
              f"{g_ratio:.3e} ({g_leaf}) of their norms")
    say("deepseek_ep_hold", arch=full.name,
        reduced=f"n_layers {full.n_layers}->{full.first_dense_layers + DEEPSEEK_CUT_GROUPS}",
        grid="x".join(map(str, grid)), backend=backend, cards=cards, rules=r0["rules"],
        params_m=f"{r0['params_m']:.1f}", batch=SHARD_B, seq=TRAIN_SEQ, dtype="float32",
        moe_calls=r0["moe_calls"], tokens_per_call=r0["tokens"][0], capacity=r0["capacity"],
        routing_near_ties=ties, held=not ties, loss=f"{r0['loss']:.6f}",
        one_rank_loss=f"{r0['one_loss']:.6f}", loss_rel_diff=f"{dloss:.3e}",
        grad_norm_ratio_max=f"{g_ratio:.3e}", grad_worst_leaf=g_leaf, leaves=r0["leaves"],
        allowed=SHARD_TOL, sharded_s=f"{r0['seconds']:.3f}",
        peak_gb_rank0=f"{r0['peak_gb']:.3f}", job_s=f"{r0['job_s']:.1f}", gpu=f"'{gpu}'")


def report_serve_hold(gpu, grid, ranks, backend, cards):
    """[sharded_serve_hold] at ``grid``: each case against one rank."""
    for name, r in ranks[0].items():
        if name == "job_s":
            continue
        tag = f"sharded_serve_hold_{name}_{grid[0]}x{grid[1]}"
        tie_calls = [call for call, diffs in r["flips"] if hold_flips(tag, call, diffs)]
        (c_ratio, c_leaf), flips, step = r["caches"]
        l_ratio, l_step = r["logits"]
        check(c_ratio <= SHARD_TOL and step <= INT8_STEP,
              f"{tag}: caches {c_ratio:.3e} ({c_leaf}) of their norm, int8 values {step} apart")
        # a routing near-tie excuses the logits from its step on, not before
        held = min((r["call_steps"][c] for c in tie_calls), default=r["steps"])
        allowed = INT8_LOGIT_TOL if r["int8"] else SHARD_TOL
        worst = max(r["logit_ratios"][:held], default=0.0)
        check(worst <= allowed, f"{tag}: logits {worst:.3e} of their norm on the steps before "
              f"step {held}, beyond {allowed}")
        if r["int8"]:
            check(r["argmax_equal_steps"] == r["steps"],
                  f"{tag}: argmax equal on {r['argmax_equal_steps']} of {r['steps']} steps")
        b, s, new = r["shape"]
        say("sharded_serve_hold", case=name, grid="x".join(map(str, grid)), backend=backend,
            cards=cards, layers=r["layers"], d_model=r["d_model"], batch=b, prompt_len=s,
            new_tokens=new, dtype="float32", cache_norm_ratio_max=f"{c_ratio:.3e}",
            cache_worst_leaf=c_leaf, int8_values_moved=flips, int8_max_step=step,
            logit_norm_ratio_max=f"{l_ratio:.3e}", logit_worst=l_step,
            logit_max_abs_diff=f"{r['logit_max_abs']:.3e}", logit_scale=f"{r['logit_scale']:.3e}",
            allowed=allowed, logit_steps_held=f"{held}/{r['steps']}",
            argmax_equal_steps=f"{r['argmax_equal_steps']}/{r['steps']}",
            moe_calls=r["moe_calls"], routing_near_ties=len(tie_calls),
            case_s=f"{r['seconds']:.1f}",
            gpu=f"'{gpu}'")


def card_top2_gap(cfg, prompts, tokens, step, row, dev, enc=None):
    """The one-rank card run's top-2 logit gap of sequence ``row`` at decode
    step ``step``, replaying its greedy loop (``tokens`` are its own;
    ``enc`` an encoder-decoder model's frames)."""
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    with torch.no_grad():
        top = torch.topk(replay(params, cfg, prompts, tokens, step, dev, enc)[row].double(),
                         2).values
    del params
    free()
    return float(top[0] - top[1])


def serve_tag(arch: str, grid) -> str:
    """The phase tag of ``arch``'s sharded serving at ``grid``."""
    return next(t for t, a in (UNEVEN_SERVE if grid == UNEVEN_GRID else SERVE_TP_ARCHS).items()
                if a == arch)


def report_serve_tp(gpu, arch, grid, ranks, backend, cards, want_tokens, dev):
    """[granite_serve_tp] / [zamba2_serve_tp] at (1, 2), and
    [granite_serve_uneven] / [whisper_serve_uneven] at ``UNEVEN_GRID``:
    every rank's tokens equal, and equal to the one-rank run's
    (``[granite_serve]``, ``[zamba2_serve]``, whisper-base's float32
    one-rank tokens of ``[whisper_hold]``) or departing at a near-tie
    (``GAP_TOL``); each rank on its block of the heads."""
    from repro_torch.dist.sharding import split_block

    cfg = configs.get(arch)
    tag = serve_tag(arch, grid)
    r0 = ranks[0]
    ssm = cfg.n_groups * cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    for i, r in enumerate(ranks):
        check(np.array_equal(r["tokens"], r0["tokens"]), f"{tag}: the ranks' tokens differ")
        check(r["launched"] == {k: (ssm * SERVE_NEW if k == "ssd_decode" else 0)
                                for k in r["launched"]}, f"{tag}: launches {r['launched']}")
        check(r["heads"] == ([cfg.n_ssm_heads // grid[1]] if ssm else []),
              f"{tag}: the decode kernel ran at heads {r['heads']}")
        check(tuple(r["head_block"]) == split_block(cfg.n_heads, grid[1], i % grid[1]),
              f"{tag}: rank {i} ran heads {r['head_block']}")
    out = r0["tokens"]
    check(out.shape == (SERVE_B, SERVE_NEW), f"{tag}: tokens of shape {out.shape}")
    prompts = serve_prompts(cfg)
    frames = serve_frames(cfg) if cfg.enc_dec else None
    same = 0
    for row in range(SERVE_B):
        if np.array_equal(out[row], want_tokens[row]):
            same += 1
            continue
        k = int(np.flatnonzero(out[row] != want_tokens[row])[0])
        gap = card_top2_gap(cfg, prompts, want_tokens, k, row, dev, frames)
        say("token_departure", case=tag, row=row, step=k, sharded_token=int(out[row, k]),
            one_rank_token=int(want_tokens[row, k]), one_rank_top2_gap=f"{gap:.3e}",
            allowed=GAP_TOL, near_tie=gap <= GAP_TOL)
        check(gap <= GAP_TOL, f"{tag}: sequence {row} departs from one rank's at step {k} "
              "beyond a near-tie")
    steps = np.array([r0["steps"] for r0 in ranks[:1]][0])
    coll_s = np.array([c[0] for c in r0["collectives"]])
    calls = sorted({c[1] for c in r0["collectives"]})
    extra = {"ssd_decode_launches_per_rank": r0["launched"]["ssd_decode"],
             "ssd_decode_launches_per_step": r0["launched"]["ssd_decode"] // SERVE_NEW,
             "ssd_decode_heads": ",".join(map(str, r0["heads"]))} if ssm else {"kernel_launches": 0}
    say(tag, arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        grid="x".join(map(str, grid)), backend=backend, cards=cards, ranks=len(ranks),
        heads=f"{cfg.n_heads}/{cfg.n_kv_heads}",
        head_blocks=",".join(f"{lo}-{hi}" for lo, hi in (r["head_block"] for r in ranks)),
        dtype="float32",
        params_m_per_rank=f"{r0['params_m']:.1f}", init_s=f"{r0['init_s']:.3f}", batch=SERVE_B,
        prompt_len=SERVE_PROMPT, new_tokens=SERVE_NEW, generate_s=f"{r0['wall']:.4f}",
        tok_per_s=f"{SERVE_B * SERVE_NEW / r0['wall']:.1f}", prefill_s=f"{r0['prefill_s']:.4f}",
        decode_step_s=f"{steps.mean():.5f}", decode_step_s_min=f"{steps.min():.5f}",
        collectives_per_step=",".join(map(str, calls)),
        collective_s_per_step=f"{coll_s.mean():.5f}",
        collective_share=f"{coll_s.mean() / steps.mean():.3f}",
        peak_gb_per_rank=",".join(f"{r['peak_gb']:.3f}" for r in ranks),
        rows_equal_to_one_rank=f"{same}/{SERVE_B}", sample=",".join(map(str, out[0][:8])),
        job_s=f"{r0['job_s']:.1f}", **extra, gpu=f"'{gpu}'")
    return r0


def phase_sharded_training(dev, gpu, rate, one_rank_losses, one_rank_tokens, t_start,
                           lingam_want, engine_fits, profile=False):
    """The sharded phases: one set of ranks per world size runs its jobs
    one after another, each job on the mesh of its own grid (a rank
    process pays ~10 s of CUDA start-up on its first products, so the
    jobs share it). Two ranks: at (1, 2) ``[granite_train_tp]``,
    ``[granite_serve_tp]``, ``[zamba2_serve_tp]``, then
    ``[train_sharded_hold]`` (granite, mamba2, zamba2, whisper),
    ``[deepseek_ep_hold]`` and ``[sharded_serve_hold]``; at (2, 1)
    ``[granite_train_fsdp]``, then the granite hold,
    ``[deepseek_ep_hold]``, ``[train_fsdp_hold]`` (granite, deepseek) and
    ``[sharded_serve_hold]``. Four ranks, at (2, 2): the four training
    holds, ``[train_fsdp_hold]`` and ``[sharded_serve_hold]``. Three ranks,
    at ``UNEVEN_GRID`` (the heads split unevenly): ``[granite_serve_uneven]``,
    ``[whisper_serve_uneven]``, then ``[train_sharded_hold]`` on
    ``UNEVEN_HOLD_ARCHS``. Then the
    decode kernel against its plain version on the inputs of a zamba2
    step of model rank 0 (H/2 = 40 heads), and its times at that shape.
    Returns (its launches per rank in the zamba2 ``generate``, its error,
    its timing without the device time, its inputs on the CPU, and each
    rank's results of ``[granite_train_tp]``, ``[granite_train_fsdp]``,
    ``[granite_serve_tp]``, ``[zamba2_serve_tp]``, ``[granite_serve_uneven]``
    and ``[whisper_serve_uneven]`` for ``[dryrun_hold]``, by tag, and the
    leader's kernel launches in ``[engine_data_sharded]``'s round).
    ``one_rank_tokens``: each served arch's one-rank float32 tokens.
    ``t_start`` is the script's start, for the elapsed seconds each set of
    ranks prints. The batched LiNGAM estimator and the async engine sharded
    over the data ranks run last in the two-rank set
    (``[fit_batch_data_sharded] grid=2x1``, ``[engine_data_sharded]``) and
    at 4 x 1 in the four-rank set, held against the one-rank results
    ``lingam_want`` (``{tag: (arrays, seconds)}``) and ``engine_fits``.
    The messaging ring's ``[ring_sharded]`` jobs run last in the two- and
    four-rank sets, at ``RING_GRIDS`` (the iJR904 slice with ``profile``);
    their results come back unreported
    (``[grid, rank results, backend, cards, the script's elapsed seconds
    at the end of their set]``) for ``report_ring_sharded``."""
    plan = {grid: [] for grid in SHARD_GRIDS}
    plan[HELD_GRID] += [("tp_train", {"argv": TP_ARGV})] + [
        ("serve_tp", {"arch": a, "grid": HELD_GRID}) for a in SERVE_TP_ARCHS.values()]
    plan[FSDP_GRID].append(("fsdp_train", {}))
    for grid in SHARD_GRIDS:
        archs = ("granite-3-2b",) + (SSM_HOLD_ARCHS if grid in SSM_HOLD_GRIDS else ())
        plan[grid] += [("sharded_hold", {"grid": grid, "arch": a}) for a in archs]
    for grid in EP_GRIDS:
        plan[grid].append(("ep_hold", {"grid": grid}))
    for grid in FSDP_HOLD_GRIDS:
        plan[grid] += [("fsdp_hold", {"grid": grid, "arch": a}) for a in FSDP_HOLD_ARCHS]
    for grid in SHARD_GRIDS:
        plan[grid].append(("serve_hold", {"grid": grid}))
    plan[CP_GRID] += [("prefill_cp", {}), ("train_cp", {})]
    for grid in CP_HOLD_GRIDS:
        plan[grid] += [("cp_hold", {"grid": grid, "arch": a}) for a in CP_HOLD_ARCHS]
    plan[UNEVEN_GRID] = [("serve_tp", {"arch": a, "grid": UNEVEN_GRID})
                         for a in UNEVEN_SERVE.values()]
    plan[UNEVEN_GRID] += [("sharded_hold", {"grid": UNEVEN_GRID, "arch": a})
                          for a in UNEVEN_HOLD_ARCHS]
    for grid in LINGAM_GRIDS:
        plan.setdefault(grid, []).append(("fit_batch_sharded", {"grid": grid, "want": {
            tag: lingam_want[tag] for tag, *_ in lingam_cases(grid)}}))
    plan[LINGAM_ENGINE_GRID].append(("engine_sharded", {"grid": LINGAM_ENGINE_GRID,
                                                        "want": engine_fits}))
    for grid in RING_GRIDS:
        plan.setdefault(grid, []).append(("ring_sharded", {"grid": grid, "profile": profile}))
    worlds: dict = {}
    for grid, jobs in plan.items():
        worlds.setdefault(math.prod(grid), []).extend((grid, job, kw) for job, kw in jobs)
    zamba2, held, cp_s, lingam_s, engine_launched, ring = None, {}, 0.0, 0.0, {}, []
    for world, planned in worlds.items():
        jobs = [(job, kw) for _, job, kw in planned]
        t0 = time.perf_counter()
        ranks, backend, cards = run_ranks(jobs, world)
        seconds = time.perf_counter() - t0
        probes = [r[0] for r in ranks]
        if backend == "gloo":
            check(all(all(p.values()) for p in probes), f"gloo_cuda_probe: {probes}")
            say("gloo_cuda_probe", **probes[0], ranks=len(ranks), gpu=f"'{gpu}'")
        for i, (grid, job, kwargs) in enumerate(planned, 1):
            results = [r[i] for r in ranks]
            if job in CP_JOBS:
                cp_s += results[0]["job_s"]
            if job in LINGAM_JOBS:
                lingam_s += results[0]["job_s"]
            if job == "tp_train":
                report_granite_train_tp(gpu, grid, results, backend, cards, one_rank_losses)
                held["granite_train_tp"] = results
            elif job == "serve_tp":
                r0 = report_serve_tp(gpu, kwargs["arch"], grid, results, backend, cards,
                                     one_rank_tokens[kwargs["arch"]], dev)
                zamba2 = r0 if kwargs["arch"] == "zamba2-2.7b" else zamba2
                held[serve_tag(kwargs["arch"], grid)] = results
            elif job == "sharded_hold":
                report_train_sharded_hold(gpu, grid, results, backend, cards)
            elif job == "ep_hold":
                report_deepseek_ep_hold(gpu, grid, results, backend, cards)
            elif job == "fsdp_hold":
                report_train_fsdp_hold(gpu, grid, results, backend, cards)
            elif job == "fsdp_train":
                report_granite_train_fsdp(gpu, results, backend, cards, one_rank_losses,
                                          held["granite_train_tp"])
                held["granite_train_fsdp"] = results
            elif job == "prefill_cp":
                report_granite_prefill_cp(gpu, results, backend, cards)
                held["granite_prefill_cp"] = results
            elif job == "train_cp":
                report_granite_train_cp(gpu, results, backend, cards)
                held["granite_train_cp"] = results
            elif job == "cp_hold":
                report_train_cp_hold(gpu, grid, results, backend, cards)
            elif job == "fit_batch_sharded":
                report_fit_batch_sharded(gpu, grid, results, backend, cards, kwargs["want"])
            elif job == "engine_sharded":
                report_engine_sharded(gpu, grid, results, backend, cards)
                engine_launched = results[0]["launched"]
            elif job == "ring_sharded":  # reported after [ring_ecoli], its one-rank reference
                ring.append([grid, results, backend, cards, None])
            else:
                report_serve_hold(gpu, grid, results, backend, cards)
        for r in ring:
            r[4] = r[4] if r[4] is not None else time.perf_counter() - t_start
        grids = dict.fromkeys(grid for grid, _, _ in planned)
        say("sharded_ranks", grids=",".join("x".join(map(str, g)) for g in grids),
            ranks=len(ranks), backend=backend, cards=cards,
            jobs=",".join(job for _, job, _ in planned), phase_s=f"{seconds:.1f}",
            elapsed_s=f"{time.perf_counter() - t_start:.1f}", gpu=f"'{gpu}'")
    say("cp_jobs", jobs=",".join(CP_JOBS), seconds=f"{cp_s:.1f}", budget_s=CP_JOBS_S,
        within=cp_s <= CP_JOBS_S, gpu=f"'{gpu}'")
    say("lingam_sharded_jobs", jobs=",".join(LINGAM_JOBS), seconds=f"{lingam_s:.1f}",
        budget_s=LINGAM_JOBS_S, within=lingam_s <= LINGAM_JOBS_S, gpu=f"'{gpu}'")
    args = [a.to(dev) for a in zamba2["ssd_inputs"]]
    err = hold_ssd("zamba2_tp_rank0_layer0", args)
    return (zamba2["launched"]["ssd_decode"], err, ssd_times(args, rate, gpu, profile=False),
            zamba2["ssd_inputs"], held, engine_launched, ring)


def phase_ssd_device_tp(gpu, inputs, timing):
    """[ssd_decode_device_time]: the decode kernel's device time at the
    per-rank shape (``inputs``, CPU tensors of a zamba2 step of model rank
    0) in a process of its own, after every other profiler session of this
    run. Returns ``timing`` (``ssd_times``) with the device time in."""
    ranks, _, _ = run_ranks([("ssd_device", {"inputs": inputs})], 1)
    dev_ms = ranks[0][1]["device_ms"]
    ms, plain_ms, bound, shape, _, wrapper_ms = timing
    say("ssd_decode_device_time", shape=shape, device_ms=f"{dev_ms:.5f}", bound_ms=f"{bound:.5f}",
        device_fraction_of_bound=f"{bound / dev_ms:.3f}", kernel_ms=f"{ms:.5f}",
        process="own", gpu=f"'{gpu}'")
    return ms, plain_ms, bound, shape, dev_ms, wrapper_ms


# ---------------------------------------------------------------------------
# the baselines (core/ica_lingam.py, core/poly_scores.py)
# ---------------------------------------------------------------------------

EASY_P5 = sem.SemSpec(p=5, n=20000, density="sparse", seed=3)  # tests/test_ica_lingam.py


def phase_ica_lingam(dev, gpu):
    """ICA-LiNGAM at the E. coli core size and on the easy p=5 SEM of
    ``tests/test_ica_lingam.py``: the card against the CPU from the same
    random start ``w0`` (W, orders, iterations, seconds), with ``fit``'s
    time beside it. At p=5 both converge and the orders are held equal. At
    E. coli core FastICA reaches max_iter without converging: the whitened
    data is ill-conditioned and two CPU runs with other thread counts
    already part, so there W and the order are printed, not held."""
    for name, spec in (("ecoli_core", sem.SemSpec(p=ECOLI[0], n=ECOLI[1], density="sparse", seed=0)),
                       ("easy_p5", EASY_P5)):
        x = sem.generate(spec)["x"]
        w0 = np.random.default_rng(0).standard_normal((spec.p, spec.p)).astype(np.float32)
        ica._fast_ica(x, w0=w0, device=dev)  # warm-up: solver handles
        (w_k, it_k), card_s = timed(lambda: ica._fast_ica(x, w0=w0, device=dev))
        t0 = time.perf_counter()
        w_c, it_c = ica._fast_ica(x, w0=w0, device="cpu")
        cpu_s = time.perf_counter() - t0
        check(bool(torch.all(torch.isfinite(w_k))), f"{name}: non-finite unmixing matrix")
        order_k, b_k = ica.ica_lingam(x, w0=w0, device=dev)
        order_c, _ = ica.ica_lingam(x, w0=w0, device="cpu")
        w_diff, w_ok = within(w_k.cpu(), w_c, ATTN_ATOL, ATTN_RTOL)
        if name == "easy_p5":
            check(it_k < 500 and it_c < 500, f"{name}: FastICA did not converge")
            check(w_ok and order_k == order_c, f"{name}: the card's W or order differs from the CPU's")
        fit(x, device=dev)  # warm-up
        _, fit_s = timed(lambda: fit(x, device=dev))
        say("ica_lingam", case=name, p=spec.p, n=spec.n, iterations=it_k, iterations_cpu=it_c,
            converged=it_k < 500, fast_ica_s=f"{card_s:.4f}", fast_ica_cpu_s=f"{cpu_s:.4f}",
            w_max_abs_diff_vs_cpu=f"{w_diff:.3e}", w_scale=f"{w_c.abs().max().item():.3e}",
            w_within_tol=w_ok, orders_equal=order_k == order_c,
            b_finite=bool(np.isfinite(b_k).all()), fit_s=f"{fit_s:.4f}", gpu=f"'{gpu}'")


def phase_poly_scores(dev, gpu):
    """The polynomial scorer on the first find-root's inputs at the E. coli
    core size and the iJR904 slice: times of ``cross_power_moments``,
    ``poly_scores`` and ``hybrid_find_root`` beside ``find_root_dense`` under
    ``hopper_fused``; the hybrid root equals the dense root."""
    for name, spec in (("ecoli_core", sem.SemSpec(p=ECOLI[0], n=ECOLI[1], density="sparse", seed=0)),
                       ("ijr904_slice", sem.SemSpec(p=SLICE[0], n=SLICE[1], seed=1))):
        xn, c = normalized(sem.generate(spec)["x"], dev)
        mask = torch.ones((spec.p,), dtype=torch.bool, device=dev)
        root, s_dense = paralingam.find_root_dense(xn, c, mask, score_backend="hopper_fused")
        h_root, h_score = poly.hybrid_find_root(xn, c, mask)
        check(int(h_root) == int(root), f"{name}: hybrid root {int(h_root)} != dense root {int(root)}")
        check(bool(torch.isfinite(h_score)), f"{name}: non-finite hybrid score")
        s_approx, _ = poly.poly_scores(xn, c, mask)
        rank = int((torch.argsort(s_approx) == root).nonzero()[0])
        cpm_ms = time_ms(lambda: poly.cross_power_moments(xn), reps=5)
        poly_ms = time_ms(lambda: poly.poly_scores(xn, c, mask), reps=5)
        hybrid_ms = time_ms(lambda: poly.hybrid_find_root(xn, c, mask), reps=5)
        dense_ms = time_ms(lambda: paralingam.find_root_dense(xn, c, mask,
                                                              score_backend="hopper_fused"), reps=5)
        say("poly_scores", case=name, p=spec.p, n=spec.n, dense_root=int(root),
            hybrid_root=int(h_root), dense_root_rank_in_approx=rank,
            cross_power_moments_ms=f"{cpm_ms:.4f}", poly_scores_ms=f"{poly_ms:.4f}",
            hybrid_find_root_ms=f"{hybrid_ms:.4f}", find_root_dense_hopper_fused_ms=f"{dense_ms:.4f}",
            gpu=f"'{gpu}'")


# ---------------------------------------------------------------------------
# the messaging ring (dist/ring.py, dist/ring_order.py)
# ---------------------------------------------------------------------------


def ring_runs(x, dev, cfg_kw, mesh, warm: bool = True):
    """One timed ``causal_order_ring`` of ``x``, after a warm-up if
    ``warm``: (result, seconds, launches of kernel #3 and of the update
    kernel's ring mode in the timed run)."""
    cfg = ParaLiNGAMConfig(order_backend="ring", **cfg_kw)
    if warm:
        causal_order_ring(x, cfg, mesh=mesh, device=dev)
    reset_counts()
    res, t = timed(lambda: causal_order_ring(x, cfg, mesh=mesh, device=dev))
    launched = counts()
    return res, t, launched["pairwise_moments"], launched["ring_update"]


def phase_ring_ecoli(dev, gpu, profile: bool):
    """The messaging ring on one card: one shard (R=1) under an NCCL process
    group of one rank (``file://`` init), through ``causal_order_ring``, at
    the E. coli core size, dense and with the threshold, under
    ``hopper_fused`` (both ``hopper`` names run the square kernel in the
    ring, and the update kernel's ring mode): the orders of the scan with
    the same kernel (``hopper``), the runs without a process group (one
    before the group exists, one after it is gone: the wall times read
    none, NCCL, none; the threshold runs no warm-up, the dense ones loaded
    every kernel) bit-equal (orders and every counter), 84 square launches
    and 84 ring-mode launches per dense order, no collective under the
    group (a ``CollectiveLedger`` around its runs: every dimension has one
    rank), ``wire`` all zero, ``fit(order_backend="ring")`` with the scan
    fit's B and noise variances; ``ring_find_root`` on the degenerate
    one-shard ring runs the square kernel once and gives the dense root;
    wall times beside the scan's, here and at the iJR904 slice (where the
    orders mean nothing; its threshold runs only with ``--profile``).
    Returns (the dense ring's square launches, its ring-mode launches, the
    degenerate find-root's square launches, what ``[ring_sharded]`` holds
    its ranks against)."""
    import torch.distributed as dist

    from repro_torch.core.pairwise import dense_scores
    from repro_torch.core.paralingam import causal_order_scan
    from repro_torch.dist.ring import ring_find_root
    from repro_torch.launch.mesh import make_ring_mesh

    p, n = ECOLI
    data = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=0))
    x = data["x"]
    kinds = (("dense", RING_DENSE), ("threshold", RING_THRESHOLD))
    scan_cfg = ParaLiNGAMConfig(score_backend="hopper")
    thr_scan_cfg = ParaLiNGAMConfig(score_backend="hopper", threshold=True, chunk=16)
    causal_order_scan(x, scan_cfg, device=dev)  # warm-up
    scan, t_scan = timed(lambda: causal_order_scan(x, scan_cfg, device=dev))
    thr_scan, t_thr_scan = timed(lambda: causal_order_scan(x, thr_scan_cfg, device=dev))
    alone = {k: ring_runs(x, dev, kw, None, warm=k == "dense") for k, kw in kinds}

    init = _build.BUILD_DIR / f"ring_init_{os.getpid()}"  # git-ignored
    init.parent.mkdir(parents=True, exist_ok=True)
    init.unlink(missing_ok=True)
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0, world_size=1)
    try:
        mesh = make_ring_mesh(1, 1, 1)
        with CollectiveLedger() as ledger:
            runs = {k: ring_runs(x, dev, kw, mesh, warm=False) for k, kw in kinds}
        xn, c = normalized(x, dev)
        mask = torch.ones(p, dtype=torch.bool, device=dev)
        reset_counts()
        root, s_ring = ring_find_root(xn, c, mask, mesh, score_backend="hopper_fused")
        fr_launches = counts()["pairwise_moments"]
        (res_f, b_f), t_fit = timed(lambda: fit(
            x, ParaLiNGAMConfig(order_backend="ring", **RING_DENSE), device=dev))
        slice_x = sem.generate(sem.SemSpec(p=SLICE[0], n=SLICE[1], density="sparse", seed=1))["x"]
        slice_runs = {"dense": ring_runs(slice_x, dev, RING_DENSE, mesh)[:2]}
        causal_order_scan(slice_x, scan_cfg, device=dev)  # warm-up
        slice_scans = {"dense": timed(lambda: causal_order_scan(slice_x, scan_cfg, device=dev))}
        if profile:  # 50-70 s on the card, and nothing held
            # no warm-up: the dense runs built and loaded everything it uses
            slice_runs["threshold"] = ring_runs(slice_x, dev, RING_THRESHOLD, mesh, warm=False)[:2]
            slice_scans["threshold"] = timed(
                lambda: causal_order_scan(slice_x, thr_scan_cfg, device=dev))
    finally:
        dist.destroy_process_group()
        init.unlink(missing_ok=True)
    after = {k: ring_runs(x, dev, kw, None, warm=False) for k, kw in kinds}
    (res_s, b_s), _ = timed(lambda: fit(x, scan_cfg, device=dev))

    zero_wire = {"pods": 1, "ring": 1, "hops_intra": 0, "hops_cross": 0, "hops_overlapped": 0,
                 "seq_hops": 0, "seq_cross_hops": 0, "overlap_frac": 0.0}
    for kind, scan_res, t_ref in (("dense", scan, t_scan), ("threshold", thr_scan, t_thr_scan)):
        res, t, launches, upd = runs[kind]
        res0, t0, launches0, upd0 = alone[kind]
        res1, t1, _, _ = after[kind]
        same = hold_order(f"ring_{kind}_vs_scan_hopper", res.order, scan.order, x, dev)
        same_thr = hold_order(f"ring_{kind}_vs_scan_{kind}", res.order, scan_res.order, x, dev)
        bit_equal = res == res0 == res1
        say("ring_ecoli", run=kind, p=p, n=n, topology="1x1x1", backend="nccl",
            order_equals_scan_hopper=same, order_equals_scan_same_evaluation=same_thr,
            equal_without_process_group=bit_equal, square_launches=launches,
            square_launches_without_process_group=launches0, update_launches=upd,
            update_launches_without_process_group=upd0, comparisons=res.comparisons,
            rounds=res.rounds, converged=res.converged, wire_zero=res.wire == zero_wire,
            collectives_under_the_group=ledger.calls,
            ring_s_none_nccl_none=f"{t0:.4f},{t:.4f},{t1:.4f}", scan_s=f"{t_ref:.4f}",
            gpu=f"'{gpu}'")
        check(bit_equal, f"ring {kind}: the run without a process group differs")
        check(res.wire == zero_wire, f"ring {kind}: wire counters {res.wire} at one shard")
        check(res.converged, f"ring {kind} did not converge")
        check(upd == upd0 == p - 1, f"ring {kind}: {upd} ring-mode launches for {p - 1} updates")
        if kind == "dense":
            check(launches == launches0 == p - 1,
                  f"{launches} square launches for {p - 1} dense find-roots")
    check(ledger.calls == 0, f"the one-shard ring issued {ledger.calls} collectives")
    s_dense = dense_scores(xn, c, mask)[0]
    fr_err = (s_ring - s_dense).abs()
    fr_ok = bool(torch.all(fr_err <= fs.score_tolerance(s_dense, xn, c, mask)))
    say("ring_find_root", p=p, n=n, topology="1x1x1", backend="nccl", degenerate=True,
        square_launches=fr_launches, root=int(root), dense_root=int(torch.argmin(s_dense)),
        max_abs_err=f"{fr_err.max().item():.3e}", within_tolerance=fr_ok, gpu=f"'{gpu}'")
    check(fr_launches == 1, f"the degenerate ring_find_root made {fr_launches} square launches")
    check(int(root) == int(torch.argmin(s_dense)) and fr_ok,
          "the degenerate ring_find_root disagrees with the plain dense evaluation")
    same = res_f.order == res_s.order
    b_err = (b_f - b_s).abs().max().item()
    nv_err = float(np.max(np.abs(res_f.noise_var - res_s.noise_var)))
    say("ring_fit", grid="1x1x1", p=p, n=n, order_equals_scan_fit=same, b_max_abs_diff=b_err,
        noise_var_max_abs_diff=nv_err, fit_s=f"{t_fit:.4f}", gpu=f"'{gpu}'")
    check(same and b_err == 0.0 and nv_err == 0.0,
          "fit(order_backend='ring') differs from the scan fit")
    if "threshold" not in slice_runs:
        say("ring_slice", run="threshold", skipped=True, reason="runs with --profile")
    for kind in slice_runs:
        (res, t), (ref, t_ref) = slice_runs[kind], slice_scans[kind]
        say("ring_slice", run=kind, p=SLICE[0], n=SLICE[1], ring_s=f"{t:.4f}",
            scan_s=f"{t_ref:.4f}", comparisons=res.comparisons, rounds=res.rounds,
            converged=res.converged, order_equals_scan=res.order == ref.order, held=False,
            gpu=f"'{gpu}'")
    want = {"dense": {"scan_order": scan.order, "x": x},
            "threshold": {"scan_order": thr_scan.order, "x": x},
            "ring_s": {"ecoli_dense": runs["dense"][1], "ecoli_threshold": runs["threshold"][1],
                       "ijr904_slice_dense": slice_runs["dense"][1]},
            "scan_s": {"ecoli_dense": t_scan, "ecoli_threshold": t_thr_scan,
                       "ijr904_slice_dense": slice_scans["dense"][1]},
            "fit_order": res_s.order, "fit_b": b_s.cpu(), "fit_noise_var": res_s.noise_var}
    return runs["dense"][2], runs["dense"][3], fr_launches, want


#: Ring topologies whose row blocks ``[ring_block_kernel]`` holds: (pods, ring).
RING_TOPOLOGIES = ((1, 2), (1, 4), (1, 8), (2, 2))


def ring_block_pairs(m: int, pods: int, ring: int):
    """(own, visiting) row slices of block 0 against each block it visits
    in ``make_hier_plan(pods, ring)``."""
    from repro_torch.utils.schedule import make_hier_plan

    m_l = m // (pods * ring)
    plan = make_hier_plan(pods, ring)
    return [(slice(0, m_l), slice(src * m_l, (src + 1) * m_l))
            for src in (plan.src(e, t, 0, 0) for e, t, _ in plan.processed_offsets())]


def phase_ring_block_kernel(dev, gpu, ecoli_x):
    """The square kernel against its plain version on the blocks the ring
    passes it at R = 2, 4, 8 and (P, R) = (2, 2): own rows against each
    visiting block (each side with its own live mask) and the reverse
    direction with the transposed correlation block, at the E. coli fit's
    first stage (m=128, n=10000, the fit's mask) and at the p=512 stage
    shape (m=512, n=2000, Gaussian rows: the SEM's near-collinear pairs
    amplify rounding past any sum tolerance); and the same on the two
    sample shards of n/2, whose sums add up to the full-n sums within the
    tolerance. Live sums within ``sum_tolerance``, dead pairs exactly 0.
    Returns the max abs error."""
    stages = capture_dense_inputs(ecoli_x, "hopper", dev)
    xe, ce, me = stages[max(stages)]
    xg, cg = normalized(gauss_data(*SLICE, 1), dev)
    mg = torch.ones(SLICE[0], dtype=torch.bool, device=dev)
    worst = 0.0
    for stage, (x_, c_, m_) in ((f"ecoli_m{xe.shape[0]}", (xe, ce, me)),
                                (f"gauss_m{SLICE[0]}", (xg, cg, mg))):
        n = x_.shape[1]
        halves = (slice(0, n // 2), slice(n // 2, n))
        for pods, ring in RING_TOPOLOGIES:
            ratio, sum_ratio, errs, zero, calls = 0.0, 0.0, [], True, 0
            for own, vis in ring_block_pairs(x_.shape[0], pods, ring):
                for a, b, c_blk in ((own, vis, c_[own, vis]), (vis, own, c_[own, vis].T)):
                    xi, xj, cb = x_[a].contiguous(), x_[b].contiguous(), c_blk.contiguous()
                    li, lj = m_[a].contiguous(), m_[b].contiguous()
                    sel = li[:, None] & lj[None, :]
                    full = None
                    parts = []
                    for cols in (slice(0, n),) + halves:
                        xs_i, xs_j = xi[:, cols].contiguous(), xj[:, cols].contiguous()
                        k = ps.pairwise_moments(xs_i, xs_j, cb, live_i=li, live_j=lj)
                        r = ps.pairwise_moments_ref(xs_i, xs_j, cb, live_i=li, live_j=lj)
                        calls += 1
                        tol = ps.sum_tolerance(xs_i, xs_j, cb)[sel].double()
                        for kk, rr in zip(k, r):
                            zero = zero and bool(torch.all(kk[~sel] == 0))
                            if bool(sel.any()):
                                e = (kk[sel].double() - rr[sel].double()).abs()
                                errs.append(e.max().item())
                                ratio = max(ratio, (e / tol).max().item())
                        if full is None:
                            full, full_tol = k, tol
                        else:
                            parts.append(k)
                    if bool(sel.any()):
                        for q in range(2):
                            e = (parts[0][q][sel].double() + parts[1][q][sel].double()
                                 - full[q][sel].double()).abs()
                            sum_ratio = max(sum_ratio, (e / full_tol).max().item())
            torch.cuda.synchronize()
            ok = ratio <= 1.0 and sum_ratio <= 1.0 and zero
            worst = max([worst] + errs)
            say("ring_block_kernel", stage=stage, topology=f"{pods}x{ring}",
                block_rows=x_.shape[0] // (pods * ring), launches=calls,
                max_abs=f"{max(errs):.3e}", max_err_over_tol=f"{ratio:.3e}",
                half_n_shards_sum_over_tol=f"{sum_ratio:.3e}", dead_pairs_zero=zero, ok=ok,
                gpu=f"'{gpu}'")
            check(ok, f"the square kernel disagrees on the ring's {stage} {pods}x{ring} blocks")
    return worst



# ---------------------------------------------------------------------------
# the messaging ring over several ranks (in the sharded phases' sets)
# ---------------------------------------------------------------------------

# [ring_sharded]: (pods, ring, model) grids run in the two- and four-rank
# sets: the E. coli core order, dense under hopper_fused, at every grid; the
# threshold ring at RING_THRESHOLD_GRIDS; with --profile, the iJR904 slice
# (times only: its f32 order is degenerate) at RING_SLICE_GRID; fit(order_backend="ring")
# over the world ring at RING_FIT_GRID. RING_JOBS_S is the jobs' budget,
# printed beside their seconds without failing on it.
RING_GRIDS = ((1, 2, 1), (1, 4, 1), (2, 2, 1), (1, 2, 2))
RING_THRESHOLD_GRIDS = ((1, 2, 1), (2, 2, 1))
RING_SLICE_GRID, RING_FIT_GRID = (1, 4, 1), (1, 2, 1)
RING_JOBS_S = 90
RING_DENSE = dict(score_backend="hopper_fused")
RING_THRESHOLD = dict(score_backend="hopper_fused", threshold=True, chunk=16)


def ring_runs_of(grid, profile: bool = False) -> list:
    """(name, (p, n, seed), config kwargs, timed twice) of the ring orders
    ``[ring_sharded]`` runs at ``grid``: the dense E. coli order a second
    time, without the clock's synchronizations, at ``RING_FIT_GRID``; the
    iJR904 slice only with ``profile``."""
    runs = [("ecoli_dense", ECOLI + (0,), RING_DENSE, grid == RING_FIT_GRID)]
    if grid in RING_THRESHOLD_GRIDS:
        runs.append(("ecoli_threshold", ECOLI + (0,), RING_THRESHOLD, False))
    if profile and grid == RING_SLICE_GRID:
        runs.append(("ijr904_slice_dense", SLICE + (1,), RING_DENSE, False))
    return runs


def kept_hops(pods: int, ring: int, q: int, i: int) -> int:
    """The hops of ``make_hier_plan(pods, ring)`` that row block (q, i)
    computes (the other endpoint takes a self-conjugate hop it does not
    keep): kernel #3 runs once per find-root for the own block and twice
    for each of these."""
    from repro_torch.utils.schedule import make_hier_plan

    plan = make_hier_plan(pods, ring)
    return sum(bool(plan.keep(dd, q * ring + i, plan.src(e, t, q, i)))
               for e, t, dd in plan.processed_offsets())


def rank_ring_sharded(grid, profile=False):
    """[ring_sharded] on this rank: ``causal_order_ring`` on the card over a
    ``make_ring_mesh(*grid)`` mesh for each of ``ring_runs_of(grid, profile)``, the
    first run of each under a ``CollectiveClock`` with kernel #3's and the
    update kernel's launches counted, a dense one timed once more alone;
    at ``RING_FIT_GRID`` also ``fit(order_backend="ring")`` with no mesh
    (the world ring). Returns each run's order, counters, ``wire``,
    per-iteration hops and rounds, launches, collectives by op, seconds."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_ring_mesh

    dev = torch.device(RANK_DEVICE)
    mesh = make_ring_mesh(*grid, device_type=RANK_DEVICE)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    out = {"rank": dist.get_rank(), "coord": coord,
           "kept": kept_hops(grid[0], grid[1], coord["pod"], coord["ring"]), "runs": {}}
    for name, (p, n, seed), kw, twice in ring_runs_of(grid, profile):
        x = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=seed))["x"]
        cfg = ParaLiNGAMConfig(order_backend="ring", **kw)
        reset_counts()
        clock = CollectiveClock(dist.get_backend())
        with clock:
            res, t = timed(lambda: causal_order_ring(x, cfg, mesh=mesh, device=dev))
        run = {"p": p, "n": n, "order": res.order, "comparisons": res.comparisons,
               "rounds": res.rounds, "converged": res.converged, "wire": res.wire,
               "hops": [it["hops"] for it in res.per_iteration],
               "rounds_it": [it["rounds"] for it in res.per_iteration],
               "launched": counts(), "by_op": clock.by_op(), "seconds": [t]}
        if twice:
            run["seconds"].append(timed(lambda: causal_order_ring(x, cfg, mesh=mesh,
                                                                  device=dev))[1])
        out["runs"][name] = run
    if grid == RING_FIT_GRID:
        x = sem.generate(sem.SemSpec(p=ECOLI[0], n=ECOLI[1], density="sparse", seed=0))["x"]
        (res, b), t = timed(lambda: fit(x, ParaLiNGAMConfig(order_backend="ring", **RING_DENSE),
                                        device=dev))
        out["fit"] = {"order": res.order, "b": b.cpu(), "noise_var": res.noise_var,
                      "wire": res.wire, "seconds": t}
    return out


RANK_JOBS["ring_sharded"] = rank_ring_sharded


def wire_of(hops_per_iteration) -> dict:
    """``ParaLiNGAMResult.wire``'s hop totals from per-iteration counts."""
    io, is_, co, cs = (sum(h[k] for h in hops_per_iteration) for k in range(4))
    return {"hops_intra": io + is_, "hops_cross": co + cs, "hops_overlapped": io + co,
            "seq_hops": is_ + cs, "seq_cross_hops": cs}


def report_ring_sharded(gpu, ring_sets, want, profile=False):
    """[ring_sharded]: one line per (grid, run), every rank's numbers; each
    rank's order held against the one-rank scan's on the card with the same
    evaluation (``hold_order``: a departure passes only at an f32 near-tie),
    ``wire`` against ``make_hier_plan``'s hop counts (times the rounds of a
    threshold iteration), kernel #3's launches on every rank against 1 + 2
    per kept hop and find-root (dense), the update kernel's against 1 per
    iteration (2 where the samples are sharded); ``[ring_fit]`` at
    ``RING_FIT_GRID`` against the scan fit. ``ring_sets``: (grid, rank
    results, backend, cards, the set's elapsed seconds); ``want``: what
    ``phase_ring_ecoli`` measured on one rank. Returns the launches of
    kernel #3 and of the update kernel per rank in the dense E. coli orders,
    by grid, and the jobs' seconds."""
    from repro_torch.utils.schedule import make_hier_plan

    launches, seconds = {}, 0.0
    for grid, ranks, backend, cards, elapsed in ring_sets:
        gid = "x".join(map(str, grid))
        seconds += ranks[0]["job_s"]
        hc = make_hier_plan(grid[0], grid[1]).hop_counts()
        plan_hops = (hc["intra_ovl"], hc["intra_seq"], hc["cross_ovl"], hc["cross_seq"])
        for name, (p, n, _), kw, _ in ring_runs_of(grid, profile):
            runs = [r["runs"][name] for r in ranks]
            thr = kw.get("threshold", False)
            equal = held = True
            if name.startswith("ecoli"):
                ref = want["threshold" if thr else "dense"]
                for r, run in zip(ranks, runs):
                    equal = hold_order(f"ring_sharded_{gid}_{name}_rank{r['rank']}",
                                       run["order"], ref["scan_order"], ref["x"],
                                       torch.device("cuda")) and equal
            else:
                held = False
            wire_ok = all(
                all(tuple(h) == tuple(v * (rd if thr else 1) for v in plan_hops)
                    for h, rd in zip(run["hops"], run["rounds_it"]))
                and {k: run["wire"][k] for k in wire_of(run["hops"])} == wire_of(run["hops"])
                for run in runs)
            sq = [run["launched"]["pairwise_moments"] for run in runs]
            upd = [run["launched"]["ring_update"] for run in runs]
            want_sq = [0 if thr else (p - 1) * (1 + 2 * r["kept"]) for r in ranks]
            want_upd = (p - 1) * (2 if grid[2] > 1 else 1)
            ops_text = ";".join(
                f"{op}:{c}/{s:.4f}s" for op, (c, s) in sorted(runs[0]["by_op"].items()))
            say("ring_sharded", grid=gid, run=name, p=p, n=n, backend=backend, cards=cards,
                order_equals_scan=equal if held else "not held", converged=all(
                    run["converged"] for run in runs),
                ranks_agree=all(run["order"] == runs[0]["order"] for run in runs),
                wire_equals_plan=wire_ok, hops_per_iteration=",".join(map(str, plan_hops)),
                rounds=runs[0]["rounds"], comparisons=runs[0]["comparisons"],
                square_launches=",".join(map(str, sq)),
                want_square_launches=",".join(map(str, want_sq)),
                update_launches=",".join(map(str, upd)), want_update_launches=want_upd,
                update_launches_per_iteration_and_rank=f"{upd[0] / (p - 1):.1f}",
                collectives_rank0=ops_text,
                seconds_per_rank=",".join(
                    "/".join(f"{t:.4f}" for t in run["seconds"]) for run in runs),
                one_rank_ring_s=f"{want['ring_s'].get(name, float('nan')):.4f}",
                scan_s=f"{want['scan_s'].get(name, float('nan')):.4f}",
                elapsed_s=f"{elapsed:.1f}", gpu=f"'{gpu}'")
            check(all(run["order"] == runs[0]["order"] for run in runs),
                  f"ring {gid} {name}: the ranks' orders differ")
            check(all(run["converged"] for run in runs), f"ring {gid} {name} did not converge")
            check(wire_ok, f"ring {gid} {name}: wire counters differ from the plan's")
            check(sq == want_sq, f"ring {gid} {name}: square launches {sq}, want {want_sq}")
            check(all(u == want_upd for u in upd),
                  f"ring {gid} {name}: update launches {upd}, want {want_upd}")
            if name == "ecoli_dense":
                launches[gid] = (sq, upd)
        if grid == RING_FIT_GRID:
            fits = [r["fit"] for r in ranks]
            b_err = max((f["b"] - want["fit_b"]).abs().max().item() for f in fits)
            nv_err = max(float(np.max(np.abs(f["noise_var"] - want["fit_noise_var"])))
                         for f in fits)
            same = all(f["order"] == want["fit_order"] for f in fits)
            say("ring_fit", grid=gid, p=ECOLI[0], n=ECOLI[1], backend=backend,
                order_equals_scan_fit=same, b_max_abs_diff=b_err,
                noise_var_max_abs_diff=nv_err,
                fit_s=",".join(f"{f['seconds']:.4f}" for f in fits), gpu=f"'{gpu}'")
            check(same and b_err == 0.0 and nv_err == 0.0,
                  f"fit(order_backend='ring') at {gid} differs from the scan fit")
    say("ring_sharded_jobs", grids=",".join("x".join(map(str, g)) for g, *_ in ring_sets),
        seconds=f"{seconds:.1f}", budget_s=RING_JOBS_S, within=seconds <= RING_JOBS_S,
        gpu=f"'{gpu}'")
    return launches, seconds


def ring_update_case(xn, c, mask, root, grid, flat: int, mi: int):
    """The arguments ``_update_shard`` hands the update kernel's ring mode on
    row block ``flat`` and sample shard ``mi`` of ``grid`` (stage buffer
    ``xn``, ``c``, live rows ``mask``, ``root`` an index into it), built as
    it builds them, each collective's result taken from the whole buffer;
    and the other sample shards' sums of squares (the plain version's),
    which ``reduce`` adds."""
    from repro_torch.core.covariance import rank1_gates

    m, n = xn.shape
    m_l, n_loc = m // (grid[0] * grid[1]), n // grid[2]
    row0 = flat * m_l
    own = slice(row0, row0 + m_l)
    shard = lambda k: slice(k * n_loc, (k + 1) * n_loc)  # noqa: E731
    x_loc = xn[own, shard(mi)].contiguous()
    row_ids = torch.arange(row0, row0 + m_l, device=xn.device)
    live = mask[own] & (row_ids != root)
    b, s_row = rank1_gates(c[own, root].contiguous(), live)
    b_col, s_col = rank1_gates(c[:, root].contiguous(),
                               mask & (torch.arange(m, device=xn.device) != root))
    others = torch.zeros(m_l, device=xn.device)
    for k in range(grid[2]):
        if k != mi:
            x_root_k = xn[root, shard(k)]
            out = (xn[own, shard(k)] - b[:, None] * x_root_k[None, :]) / s_row[:, None]
            others = others + torch.sum(torch.square(out), dim=-1)
    args = (x_loc, c[own].contiguous(), xn[root, shard(mi)].contiguous(), b, s_row, b_col,
            s_col, live)
    return args, row0, others


def ring_forced(args, row0, n, reduce, force):
    """Ring mode's launches (fused, or sums, ``reduce``, scale) on a forced
    plan, out of place: (x', c')."""
    x, c = args[0], args[1]
    xo, co = torch.empty_like(x), torch.empty_like(c)
    sq = torch.empty(x.shape[0], device=x.device)
    if reduce is None:
        cu.launch_ring(x, xo, c, co, *args[2:], sq, cu.RING_FUSED, row0, n, **force)
    else:
        cu.launch_ring(x, x, c, co, *args[2:], sq, cu.RING_SUMS, row0, n, **force)
        reduce(sq)
        cu.launch_ring(x, xo, c, co, *args[2:], sq, cu.RING_SCALE, row0, n, **force)
    torch.cuda.synchronize()
    return xo, co


def phase_ring_update_kernel(dev, gpu, x, order):
    """[ring_update_kernel]: the update kernel's ring mode against its plain
    version (the ring's torch update) at the E. coli core's first update
    (the ring's 128-row first stage, the fit's mask, the scan's first root)
    on every row block of (1, 2, 1) and on every block and sample shard of
    (1, 2, 2), where a first launch writes the sums, ``reduce`` adds the
    other shard's, a second scales: x' and c' bit-equal, out of place and
    written over the inputs. Then, on block 0 of each grid, its device ms
    per launch (profiler), the live bytes' bound at 3.35 TB/s, an empty
    kernel on the first launch's grid, and the plain version's ms. Returns (max abs error, timing of
    the (1, 2, 1) block 0 launch). ``order``: the E. coli core's order."""
    from repro_torch.core.paralingam import _compact

    p, n = ECOLI
    xn0, c0 = normalized(x, dev)
    m = 128
    sel = _compact(torch.ones((1, p), dtype=torch.bool, device=dev), m)[0]
    xn, c = xn0[sel].contiguous(), c0[sel][:, sel].contiguous()
    mask = torch.arange(m, device=dev) < p
    root = int(torch.nonzero(sel == order[0])[0, 0])
    worst, timing = 0.0, None
    for grid in ((1, 2, 1), (1, 2, 2)):
        for flat in range(grid[0] * grid[1]):
            for mi in range(grid[2]):
                args, row0, others = ring_update_case(xn, c, mask, root, grid, flat, mi)
                reduce = None if grid[2] == 1 else (lambda sq: sq.add_(others))
                kx, kc = ops.ring_update(*args, row0=row0, n=n, reduce=reduce)
                rx, rc = cu.ring_update_ref(*args, row0=row0, n=n, reduce=reduce)
                ix, ic = args[0].clone(), args[1].clone()
                ops.ring_update(ix, ic, *args[2:], row0=row0, n=n, reduce=reduce, inplace=True)
                torch.cuda.synchronize()
                err = max((kx.double() - rx.double()).abs().max().item(),
                          (kc.double() - rc.double()).abs().max().item())
                worst = max(worst, err)
                ok = (torch.equal(kx, rx) and torch.equal(kc, rc) and torch.equal(ix, kx)
                      and torch.equal(ic, kc))
                # the block under the plans it does not choose, every phase
                forced = []
                for force in (dict(cluster=2), dict(cluster=1)) if grid[2] == 1 else \
                        (dict(rows=2), dict(rows=4)):
                    fx, fc = ring_forced(args, row0, n, reduce, force)
                    forced.append(torch.equal(fx, rx) and torch.equal(fc, rc))
                ok = ok and all(forced)
                m_l, n_loc = args[0].shape
                launches = 1 if reduce is None else 2
                live_rows = int(args[7].sum())
                times = {}
                if flat == mi == 0:
                    def launch(args=args, row0=row0, reduce=reduce):
                        ops.ring_update(*args, row0=row0, n=n, reduce=reduce)

                    dev_ms = device_ms(launch, "rank1_update_kernel")
                    empty_ms, empty_dev = empty_times(cu.MODE_RING, m_l, m, n_loc, dev)
                    plain_ms = time_ms(lambda: cu.ring_update_ref(*args, row0=row0, n=n,
                                                                  reduce=reduce), reps=20)
                    bound = cu.ring_bytes(live_rows, m_l, m, n_loc) / HBM_BPS * 1e3
                    times = dict(device_ms_per_launch=f"{dev_ms:.5f}", **stage_split(launch),
                                 empty_kernel_device_ms=f"{empty_dev:.5f}",
                                 empty_kernel_ms=f"{empty_ms:.5f}", plain_ms=f"{plain_ms:.5f}",
                                 bound_ms=f"{bound:.5f}", bound_by="bytes",
                                 device_fraction_of_bound=f"{bound / (launches * dev_ms):.3f}")
                say("ring_update_kernel", grid="x".join(map(str, grid)), block=flat,
                    sample_shard=mi, m_l=m_l, m=m, n_loc=n_loc, live_rows=live_rows,
                    launches=launches, **plan_fields(cu.MODE_RING, m_l, m, n_loc),
                    x_bit_equal=torch.equal(kx, rx), c_bit_equal=torch.equal(kc, rc),
                    in_place_bit_equal=torch.equal(ix, kx) and torch.equal(ic, kc),
                    forced_plans_bit_equal=f"{sum(forced)}/{len(forced)}",
                    max_abs=f"{err:.3e}", **times, ok=ok, gpu=f"'{gpu}'")
                check(ok, f"the ring mode disagrees with its plain version at {grid} "
                          f"block {flat} shard {mi}")
                if timing is None:
                    timing = (dev_ms, plain_ms, bound, empty_dev,
                              f"m_l={m_l},m={m},n_loc={n_loc},one launch")
    return worst, timing


# ---------------------------------------------------------------------------
# the production dry run (launch/dryrun.py) held against this run
# ---------------------------------------------------------------------------

# [dryrun_hold]: each predicted per-rank peak within PEAK_TOL of the
# rank's max_memory_allocated, and the predicted temporaries (peak less
# arguments) within TEMP_TOL of the measured ones (peak less the measured
# arguments and the bytes held beside the run, ``Beside``); the phase
# within DRYRUN_HOLD_S seconds.
PEAK_TOL = 0.10
TEMP_TOL = 0.05
DRYRUN_HOLD_S = 60
# The production cell the phase prints: (arch, shape) on the 16 x 16 mesh
# as rank PRODUCTION_RANK, traced beside the held cells: yi-34b's rank 1
# holds q heads 4-7 of its 56, which cut across its GQA groups of 7 (the
# sweep's records of every cell come from ``python -m
# repro_torch.launch.dryrun --all``).
PRODUCTION_CELL, PRODUCTION_RANK = ("yi-34b", "decode_32k"), 1
# The (data, model) grid of the sharded cells held, and the serving ones'
# tags and archs.
HELD_GRID = (1, 2)
SERVE_TP_ARCHS = {"granite_serve_tp": "granite-3-2b", "zamba2_serve_tp": "zamba2-2.7b"}
# The uneven serving cells held (``UNEVEN_GRID``), and the ranks traced:
# rank 0 (11 of granite's 32 heads) and rank 2 (10).
UNEVEN_HELD = {"granite_serve_uneven": "granite-3-2b"}
UNEVEN_TRACED_RANKS = (0, 2)
# The processes that trace the held cells (the card's machine has 8 cores;
# the main process waits meanwhile).
DRYRUN_WORKERS = 7
# The context-parallel cells held: rank 0 of each (``cp_dry_record``).
CP_HELD = ("granite_prefill_cp", "granite_train_cp")
# [granite_train_fsdp]'s ranks traced and held: rank 0 alone, to keep the
# phase inside DRYRUN_HOLD_S (its cell traces ~12 s; the two data ranks of
# (2, 1) hold cells of the same shapes).
FSDP_TRACED_RANKS = 1


def dry_record(cfg, shape, grid, rank: int = 0, then=None, **kw) -> dict:
    """The dry run's record of ``cfg`` at ``shape`` on the card's path, as
    rank ``rank`` of a fake world of the (data, model) ``grid`` (None: one
    rank, no mesh); ``then(rules)`` gives a function of the cell's outputs
    traced with it."""
    if grid is None:
        return dryrun.trace_cell(cell_specs.make_cell(cfg, shape, None, **kw), None,
                                 verbose=False)
    with fake_world(grid, ("data", "model"), rank=rank) as mesh:
        cell = cell_specs.make_cell(cfg, shape, mesh, **kw)
        return dryrun.trace_cell(cell, mesh, rank=rank, verbose=False,
                                 then=None if then is None else then(cell.rules))


def logits_gathered(cfg):
    """``rules`` -> a serving step's tail after ``decode_step``: the logits
    gathered over ``model`` (the padded vocabulary's blocks) and the next
    token (``Engine.generate``'s)."""
    return lambda rules: lambda out: (
        torch.argmax(gather_over_model(out[0], 1, rules, cfg.vocab_padded), -1), out[1])


def dry_task(task) -> dict:
    """One held cell's record, ``task`` = (tag, rank, kind): a worker of
    ``dryrun_predictions``."""
    torch.set_num_threads(1)
    tag, rank, kind = task
    if tag == "production":
        arch, shape = PRODUCTION_CELL
        t0 = time.perf_counter()
        with fake_world(*production_shape(False), rank=rank) as mesh:
            rec = dryrun.cell_record(configs.get(arch), SHAPES[shape], mesh, rank=rank,
                                     device="cuda", verbose=False)
        return {**rec, "record_s": time.perf_counter() - t0}
    if tag in CP_HELD:
        return cp_dry_record(tag)
    if tag.startswith("granite_train"):
        opt = OptimizerConfig(lr=3e-4, warmup_steps=20, total_steps=TRAIN_STEPS)
        grid = {"granite_train": None, "granite_train_tp": HELD_GRID,
                "granite_train_fsdp": FSDP_GRID}[tag]
        return dry_record(configs.get("granite-3-2b"), ShapeSpec("train", "train", TRAIN_SEQ,
                                                                  TRAIN_B),
                          grid, rank, opt_cfg=opt, accum_steps=1)
    grid = UNEVEN_GRID if tag in UNEVEN_HELD else HELD_GRID
    cfg32 = configs.get({**SERVE_TP_ARCHS, **UNEVEN_HELD}[tag]).with_overrides(dtype="float32")
    total = bucket_dim(SERVE_PROMPT) + SERVE_NEW
    if kind == "prefill":
        return dry_record(cfg32, ShapeSpec("prefill", "prefill", bucket_dim(SERVE_PROMPT),
                                           SERVE_B), grid, rank, max_seq=total)
    return dry_record(cfg32, ShapeSpec("decode", "decode", total, SERVE_B), grid, rank,
                      then=logits_gathered(cfg32))


def cp_dry_record(tag: str) -> dict:
    """The record of ``[granite_prefill_cp]``'s or ``[granite_train_cp]``'s
    cell, built as ``REPRO_OPT=cp_seq`` builds it (``make_cell``), rank 0
    of ``CP_GRID``."""
    saved = os.environ.get("REPRO_OPT")
    os.environ["REPRO_OPT"] = "cp_seq"
    try:
        if tag == "granite_prefill_cp":
            cfg = configs.get("granite-3-2b").with_overrides(dtype="float32")
            return dry_record(cfg, ShapeSpec("prefill", "prefill", CP_SEQ, CP_B), CP_GRID,
                              max_seq=CP_SEQ + CP_NEW)
        opt = OptimizerConfig(lr=3e-4, warmup_steps=20, total_steps=TRAIN_STEPS)
        return dry_record(cp_train_config(), ShapeSpec("train", "train", CP_SEQ, CP_B),
                          CP_GRID, opt_cfg=opt, accum_steps=1)
    finally:
        if saved is None:
            os.environ.pop("REPRO_OPT", None)
        else:
            os.environ["REPRO_OPT"] = saved


def dryrun_predictions() -> dict:
    """The dry run of every cell ``[dryrun_hold]`` holds, at the shapes and
    meshes the phases ran them (each rank of a grid as itself), on the
    card's path; traced in ``DRYRUN_WORKERS`` spawned processes (one CPU
    thread each, a fake process group each), the longest cells first."""
    tasks = [("granite_train_cp", 0, "train"), ("granite_train", 0, "train"),
             ("granite_train_fsdp", 0, "train"), ("production", PRODUCTION_RANK, "production"),
             ("granite_prefill_cp", 0, "prefill")]
    tasks += [("granite_train_tp", r, "train") for r in range(2)]
    tasks += [(tag, r, kind) for tag in SERVE_TP_ARCHS for r in range(2)
              for kind in ("prefill", "decode")]
    tasks += [(tag, r, kind) for tag in UNEVEN_HELD for r in UNEVEN_TRACED_RANKS
              for kind in ("prefill", "decode")]
    with mp.get_context("spawn").Pool(DRYRUN_WORKERS) as pool:
        recs = dict(zip(tasks, pool.map(dry_task, tasks, chunksize=1)))
    out = {"granite_train": recs["granite_train", 0, "train"],
           "granite_train_tp": [recs["granite_train_tp", r, "train"] for r in range(2)],
           "granite_train_fsdp": [recs["granite_train_fsdp", 0, "train"]],
           "production": recs["production", PRODUCTION_RANK, "production"],
           "granite_prefill_cp": recs["granite_prefill_cp", 0, "prefill"],
           "granite_train_cp": recs["granite_train_cp", 0, "train"]}
    for tag in SERVE_TP_ARCHS:
        out[tag] = [{kind: recs[tag, r, kind] for kind in ("prefill", "decode")}
                    for r in range(2)]
    for tag in UNEVEN_HELD:
        out[tag] = {r: {kind: recs[tag, r, kind] for kind in ("prefill", "decode")}
                    for r in UNEVEN_TRACED_RANKS}
    return out


class Holds:
    """Each prediction printed beside its measurement; ``check`` fails the
    run on any miss, after every pair is printed."""

    def __init__(self):
        self.misses = []

    def pair(self, case: str, rank: int, what: str, predicted, measured, ok: bool, **kw):
        say("dryrun_hold", case=case, rank=rank, what=what, predicted=predicted,
            measured=measured, held=ok, **kw)
        if not ok:
            self.misses.append(f"{case} rank {rank}: {what} predicted {predicted}, "
                               f"measured {measured}")

    def exact(self, case, rank, what, predicted, measured):
        self.pair(case, rank, what, predicted, measured, predicted == measured)

    def peak(self, case, rank, predicted_bytes, measured_gb):
        pred = predicted_bytes / 1e9
        rel = abs(pred - measured_gb) / measured_gb
        self.pair(case, rank, "peak_gb", f"{pred:.3f}", f"{measured_gb:.3f}", rel <= PEAK_TOL,
                  rel_diff=f"{rel:.4f}", allowed=PEAK_TOL)

    def temp(self, case, rank, rec, measured_gb, arg_bytes, beside):
        """The cell's temporaries: predicted peak less predicted arguments,
        against the measured peak less the measured arguments and the bytes
        held beside the run."""
        pred = (rec["peak_bytes"] - rec["memory"]["argument_size_in_bytes"]) / 1e9
        meas = measured_gb - (arg_bytes + beside) / 1e9
        rel = abs(pred - meas) / meas
        self.pair(case, rank, "temp_gb", f"{pred:.4f}", f"{meas:.4f}", rel <= TEMP_TOL,
                  rel_diff=f"{rel:.4f}", allowed=TEMP_TOL, beside_gb=f"{beside / 1e9:.4f}")

    def check(self):
        check(not self.misses, "dryrun_hold: " + "; ".join(self.misses))


def hold_cp_cells(holds, pred, sharded):
    """The context-parallel cells' pairs: rank 0's record of each
    ``CP_HELD`` cell against its job's measurements (``sharded[tag]``):
    ``context_parallel``, the collectives per step by op and the argument
    bytes exactly, the peak within ``PEAK_TOL``, the temporaries within
    ``TEMP_TOL``."""
    for tag in CP_HELD:
        r, rec = sharded[tag][0], pred[tag]
        by_op = r["by_op"] if tag == "granite_prefill_cp" else per_step_by_op(r["by_op"])
        holds.exact(tag, r["rank"], "context_parallel", rec.get("context_parallel"), True)
        holds.exact(tag, r["rank"], "collectives_per_step_by_op",
                    {op: a["count"] for op, a in sorted(rec["collectives"]["by_op"].items())},
                    {op: n for op, (n, _) in sorted(by_op.items())})
        holds.exact(tag, r["rank"], "argument_bytes", rec["memory"]["argument_size_in_bytes"],
                    r["arg_bytes"])
        holds.peak(tag, r["rank"], rec["peak_bytes"], r["peak_gb"])
        holds.temp(tag, r["rank"], rec, r["peak_gb"], r["arg_bytes"], r["beside"])


def phase_dryrun_hold(gpu, train_held, sharded):
    """[dryrun_hold], after the last timed phase: the dry run
    (``dryrun_predictions``: each cell traced on fake tensors over a fake
    process group, each rank as itself) held against this run's
    measurements of the same cells: collectives per step equal to the
    count of a ``CollectiveLedger`` (``CollectiveClock`` on the ranks),
    argument bytes equal to the real tensors' (``StepArguments``,
    ``rank_serve_tp``), each predicted peak within ``PEAK_TOL`` of the
    rank's ``max_memory_allocated`` and its temporaries within
    ``TEMP_TOL`` of the measured ones, kernel #6's launches per step equal
    to the counted ones, each serving record's head block equal to the
    rank's. Then ``PRODUCTION_CELL``'s record (traced in the pool as rank
    ``PRODUCTION_RANK``), which must be ``ok``. Prints each pair and the
    phase's seconds (at most ``DRYRUN_HOLD_S``)."""
    t0 = time.perf_counter()
    pred = dryrun_predictions()
    trace_s = time.perf_counter() - t0
    holds = Holds()
    rec = pred["granite_train"]
    holds.exact("granite_train", 0, "collectives_per_step", rec["n_collective_ops"],
                train_held["collectives_per_step"])
    holds.exact("granite_train", 0, "argument_bytes", rec["memory"]["argument_size_in_bytes"],
                train_held["arg_bytes"])
    holds.peak("granite_train", 0, rec["peak_bytes"], train_held["peak_gb"])
    holds.temp("granite_train", 0, rec, train_held["peak_gb"], train_held["arg_bytes"],
               train_held["beside"])
    for r in sharded["granite_train_tp"]:
        rec, coll = pred["granite_train_tp"][r["rank"]], r["collective_s"]
        holds.exact("granite_train_tp", r["rank"], "collectives_per_step",
                    rec["n_collective_ops"], (coll[-1][1] - coll[0][1]) // (len(coll) - 1))
        holds.exact("granite_train_tp", r["rank"], "argument_bytes",
                    rec["memory"]["argument_size_in_bytes"], r["arg_bytes"])
        holds.peak("granite_train_tp", r["rank"], rec["peak_bytes"], r["peak_gb"])
        holds.temp("granite_train_tp", r["rank"], rec, r["peak_gb"], r["arg_bytes"],
                   r["beside"])
    for r in sharded["granite_train_fsdp"][:FSDP_TRACED_RANKS]:
        rec = pred["granite_train_fsdp"][r["rank"]]
        measured = {op: n for op, (n, _) in per_step_by_op(r["by_op"]).items()}
        holds.exact("granite_train_fsdp", r["rank"], "fsdp_axes", rec["fsdp_axes"],
                    list(r["fsdp_axes"]))
        holds.exact("granite_train_fsdp", r["rank"], "collectives_per_step_by_op",
                    {op: a["count"] for op, a in sorted(rec["collectives"]["by_op"].items())},
                    dict(sorted(measured.items())))
        holds.exact("granite_train_fsdp", r["rank"], "argument_bytes",
                    rec["memory"]["argument_size_in_bytes"], r["arg_bytes"])
        holds.peak("granite_train_fsdp", r["rank"], rec["peak_bytes"], r["peak_gb"])
        holds.temp("granite_train_fsdp", r["rank"], rec, r["peak_gb"], r["arg_bytes"],
                   r["beside"])
    hold_cp_cells(holds, pred, sharded)
    serve_held = [(tag, r, pred[tag][r["rank"]]) for tag in SERVE_TP_ARCHS for r in sharded[tag]]
    serve_held += [(tag, r, pred[tag][r["rank"]]) for tag in UNEVEN_HELD for r in sharded[tag]
                   if r["rank"] in UNEVEN_TRACED_RANKS]
    for tag, r, cells in serve_held:
        pre, dec = cells["prefill"], cells["decode"]
        for kind, rec in cells.items():
            holds.exact(tag, r["rank"], f"{kind}_head_block", rec["head_block"],
                        list(r["head_block"]))
        holds.exact(tag, r["rank"], "collectives_per_step", [dec["n_collective_ops"]],
                    sorted({c[1] for c in r["collectives"]}))
        holds.exact(tag, r["rank"], "prefill_argument_bytes",
                    pre["memory"]["argument_size_in_bytes"], r["arg_bytes"]["prefill"])
        holds.exact(tag, r["rank"], "decode_argument_bytes",
                    dec["memory"]["argument_size_in_bytes"], r["arg_bytes"]["decode"])
        top = max(cells, key=lambda k: cells[k]["peak_bytes"])
        holds.peak(tag, r["rank"], cells[top]["peak_bytes"], r["peak_gb"])
        holds.temp(f"{tag}_{top}", r["rank"], cells[top], r["peak_gb"], r["arg_bytes"][top],
                   r["beside"])
        holds.exact(tag, r["rank"], "ssd_decode_launches_per_step",
                    dec["kernels"].get("ssd_decode", 0),
                    r["launched"]["ssd_decode"] // SERVE_NEW)
    prod = pred["production"]
    say("dryrun_production", cell=prod["cell"], mesh=prod["mesh"], rank=PRODUCTION_RANK,
        status=prod["status"], reason=f"'{prod.get('reason', '')}'",
        head_block=",".join(map(str, prod.get("head_block", []))),
        peak_gb=f"{prod.get('peak_bytes', 0) / 1e9:.3f}",
        collectives=prod.get("n_collective_ops"), seconds=f"{prod['record_s']:.3f}",
        gpu=f"'{gpu}'")
    print("[dryrun_record] " + json.dumps(prod, sort_keys=True), flush=True)
    check(prod["status"] == "ok", f"dryrun_production: {prod['cell']} {prod['status']}")
    held = [pred["granite_train"], *pred["granite_train_tp"], *pred["granite_train_fsdp"],
            *(pred[tag] for tag in CP_HELD),
            *(rec for _, _, cells in serve_held for rec in cells.values())]
    phase_s = time.perf_counter() - t0
    say("dryrun_hold_phase", phase_s=f"{phase_s:.1f}", allowed_s=DRYRUN_HOLD_S,
        held_cells=len(held), held_cells_trace_s=f"{sum(r['trace_s'] for r in held):.1f}",
        predictions_s=f"{trace_s:.1f}", gpu=f"'{gpu}'")
    holds.check()
    check(phase_s <= DRYRUN_HOLD_S, f"dryrun_hold took {phase_s:.1f} s")


# ---------------------------------------------------------------------------
# the estimator in float64
# ---------------------------------------------------------------------------

# The float64 serial oracle's causal order of the E. coli core (p=85,
# n=10000, ``sem.SemSpec(p=85, n=10_000, density="sparse", seed=0)``), from
#   PYTHONPATH=src python -c "from repro_torch.core import direct_lingam, sem;
#   print(direct_lingam.causal_order(sem.generate(sem.SemSpec(p=85, n=10_000,
#   density='sparse', seed=0))['x']))"
# (95 s on a CPU). Both float32 orders depart from it (ROADMAP queue 3).
ECOLI_F64_ORDER = [
    23, 0, 67, 26, 74, 13, 33, 31, 32, 7, 65, 79, 58, 49, 78, 72, 54, 64, 81, 50, 25, 52,
    70, 37, 10, 66, 53, 30, 47, 84, 68, 41, 71, 75, 76, 21, 2, 20, 27, 8, 16, 48, 39, 62,
    63, 82, 35, 1, 80, 51, 34, 11, 55, 24, 42, 22, 3, 4, 38, 57, 83, 59, 61, 9, 15, 45, 56,
    14, 29, 40, 69, 36, 73, 19, 6, 44, 5, 18, 12, 60, 46, 77, 17, 28, 43]
F64 = dict(dtype=torch.float64)


def phase_fit_f64(dev, gpu, core):
    """[fit_f64]: the E. coli core in float64 on the card. Under ``torch``
    the order is the float64 oracle's (``ECOLI_F64_ORDER``); ``hopper_fused``
    (kernel #1 on float32 copies of the float64 state) gives the order of
    ``torch_fused`` (its plain version's sweep on the same copies), or
    departs at an f32 near-tie; p - 1 kernel launches and no update-kernel
    launch (``dispatch_stats["rank1_update"]`` 0: float64 takes the torch
    updates). Seconds beside the float32 fit's. Returns kernel #1's
    launches in the float64 fit."""
    x = core["x"]
    p, n = x.shape
    check(sem.is_valid_causal_order(ECOLI_F64_ORDER, sem.generate(sem.SemSpec(
        p=p, n=n, density="sparse", seed=0))["b_true"]), "the float64 oracle order is not valid")
    run_fit(x, "hopper_fused", dev, **F64)  # warm-up
    res_t, b_t, t_t, _, upd_t = run_fit(x, "torch", dev, **F64)
    res_f, b_f, t_f, _, _ = run_fit(x, "torch_fused", dev, **F64)
    paralingam.reset_dispatch_stats()
    res_k, b_k, t_k, launches, updates = run_fit(x, "hopper_fused", dev, **F64)
    stat = paralingam.dispatch_stats_snapshot()["rank1_update"]
    same = hold_order("fit_f64_hopper_fused_vs_torch_fused", res_k.order, res_f.order, x, dev,
                      torch.float64)
    b_err = (b_k - b_f).abs().max().item()
    say("fit_f64", p=p, n=n, order_equals_f64_oracle=res_t.order == ECOLI_F64_ORDER,
        torch_first_departure=first_departure(res_t.order, ECOLI_F64_ORDER),
        hopper_fused_equals_torch_fused=same,
        hopper_fused_first_departure_from_oracle=first_departure(res_k.order, ECOLI_F64_ORDER),
        torch_fused_first_departure_from_oracle=first_departure(res_f.order, ECOLI_F64_ORDER),
        float32_first_departure_from_oracle=first_departure(core["hopper_fused"][0].order,
                                                            ECOLI_F64_ORDER),
        launches=launches, find_roots=p - 1, update_launches=updates + upd_t,
        rank1_update_stat=stat, b_dtype=str(b_k.dtype).removeprefix("torch."),
        b_max_abs_diff_vs_torch_fused=f"{b_err:.3e}", fit_s_torch=f"{t_t:.4f}",
        fit_s_torch_fused=f"{t_f:.4f}", fit_s_hopper_fused=f"{t_k:.4f}",
        fit_s_hopper_fused_float32=f"{core['hopper_fused'][2]:.4f}", gpu=f"'{gpu}'")
    check(res_t.order == ECOLI_F64_ORDER, "the float64 torch fit is not the float64 oracle's order")
    check(launches == p - 1, f"{launches} kernel launches for {p - 1} float64 find-roots")
    check(updates == 0 and upd_t == 0 and stat == 0, "a float64 fit launched the update kernel")
    check(b_k.dtype == torch.float64 and bool(torch.all(torch.isfinite(b_k)))
          and np.all(np.isfinite(res_k.noise_var)), "float64 B or noise variances not finite")
    if same:
        check(b_err <= 1e-12, "float64 B differs between hopper_fused and torch_fused")
    return launches


def phase_fit_batch_f64(dev, gpu):
    """[fit_batch_f64]: 3 ragged E. coli-size requests in one float64 bucket
    under ``hopper_fused``: each row bit for bit its dataset's own
    one-dataset float64 ``fit_batch``, its order a dedicated float64
    ``fit``'s (or departing at an f32 near-tie), kernel #2 once per
    find-root, no update-kernel launch. Returns kernel #2's launches."""
    raw = ecoli_requests()[:3]
    xs, mask, nv, _ = pack_bucket(raw, *ECOLI_BUCKET, dtype=np.float64)
    cfg = ParaLiNGAMConfig(score_backend="hopper_fused", **F64)
    fit_batch(xs, cfg, n_valid=nv, mask=mask, device=dev)  # warm-up
    reset_counts()
    res, t = timed(lambda: fit_batch(xs, cfg, n_valid=nv, mask=mask, device=dev))
    launched = counts()
    p_live = [x.shape[0] for x in raw]
    differ = batch_differences(res, xs, mask, nv, cfg, p_live,
                               ("orders", "comparisons", "rounds", "converged"), dev)
    orders = res.orders.cpu().numpy()
    same_fit = [hold_order(f"fit_batch_f64_{i}", list(orders[i, :p]),
                           fit(x, cfg, device=dev)[0].order, x, dev, torch.float64)
                for i, (x, p) in enumerate(zip(raw, p_live))]
    say("fit_batch_f64", B=len(raw), bucket=f"{ECOLI_BUCKET}", seconds=f"{t:.4f}",
        equal_to_own_fit_batch=f"{len(raw) - len({d.split(':')[0] for d in differ})}/{len(raw)}",
        first_differences=",".join(differ) or "none",
        orders_equal_to_fit=f"{sum(same_fit)}/{len(raw)}",
        launches=launched["fused_score_batch"], find_roots=ECOLI_BUCKET[0] - 1,
        update_launches=launched["rank1_update"], b_dtype=str(res.b.dtype).removeprefix("torch."),
        gpu=f"'{gpu}'")
    check(not differ, "a float64 dataset's fit differs between its batch and its own")
    check(launched["fused_score_batch"] == ECOLI_BUCKET[0] - 1 and launched["rank1_update"] == 0,
          f"float64 bucket launches {launched}")
    check(res.b.dtype == torch.float64 and bool(torch.isfinite(res.b).all()),
          "float64 bucket B not finite float64")
    return launched["fused_score_batch"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gpu = gpu_line()
    print(gpu, flush=True)
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=f"'{torch.cuda.get_device_name(0)}'", count=torch.cuda.device_count())
    t0 = time.perf_counter()
    start_variant_builds()
    logs = _build.build_all()
    say("build", kernels=",".join(logs), seconds=f"{time.perf_counter() - t0:.2f}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)

    phase_sass()
    phase_math_probe(dev)
    phase_rank1_scale_probe(dev)
    phase_rank1_sum_order(dev)
    phase_update_plan(dev)
    profile = "--profile" in sys.argv[1:]
    if profile:
        profile_find_root(dev, gpu)
    err_kernel = phase_kernel(dev)
    phase_fit_small(dev)
    err_core, core = phase_fit_core(dev, gpu)
    rate = copy_rate(dev)
    say("copy_rate", bytes_per_s=f"{rate:.4e}", published_bytes_per_s=f"{HBM_BPS:.4e}",
        gpu=f"'{gpu}'")
    err_data, err_cov, cov_timing = phase_covupdate_kernel(dev, gpu, rate)
    cov_launched, path_ex, path_ec = phase_covupdate_path(
        dev, gpu, core["x"], core["hopper_fused"][0].order)
    err_rank1, rank1_timing = phase_rank1_update(dev, gpu, core)
    # before any rank process: a profiler session after them sees no device events
    err_ring_upd, ring_upd_timing = phase_ring_update_kernel(
        dev, gpu, core["x"], core["hopper_fused"][0].order)
    err_ssd, ssd_timing = phase_ssd_kernel(dev, gpu, rate)
    ssd_launches, err_serve, _ = phase_mamba2_serve(dev, gpu, profile)
    free()
    granite, granite_cfg, granite_tokens = phase_granite_serve(dev, gpu, profile)
    phase_granite_prefill_long(dev, gpu, granite, granite_cfg)
    del granite
    free()
    phase_gemma3_window(dev, gpu)
    free()
    ssd_launches_zamba2, err_zamba2, zamba2_timing, zamba2_tokens = phase_zamba2_serve(
        dev, gpu, rate, profile)
    free()
    phase_deepseek_serve(dev, gpu, profile)
    free()
    phase_llama4_serve(dev, gpu)
    free()
    whisper_tokens = phase_whisper_serve(dev, gpu, profile)
    free()
    train_losses, train_held = phase_granite_train(dev, gpu, profile)
    free()
    phase_granite_train_hold(dev, gpu)
    free()
    phase_train_resume(dev, gpu)
    free()
    err_sq, sq = phase_pairwise_kernel(dev, gpu, core["x"])
    launches_sq = phase_fit_hopper(dev, gpu, core)
    phase_causal_order_host(dev, gpu, core)
    launches, err_fit, ms, plain_ms, bound, wrapper_ms = phase_fit_slice(dev, gpu)
    err_b, ms_b, wrapper_b, plain_b, bound_b, padded_b, shape_b = phase_batch_kernel(dev, gpu)
    batch_orders, lingam_want = phase_fit_batch(dev, gpu)
    launches_sqb = phase_fit_batch_hopper(dev, gpu, batch_orders)
    launches_b, launches_upd, engine_fits = phase_engine(dev, gpu, batch_orders, profile)
    phase_threshold_ecoli(dev, gpu)
    phase_threshold_batch(dev, gpu)
    if time.perf_counter() - t_start < 500:  # well inside the 1200 s limit
        phase_threshold_slice(dev, gpu)
    else:
        say("threshold_slice", skipped=True, elapsed_s=f"{time.perf_counter() - t_start:.1f}")
    free()
    (launches_tp, err_tp, tp_timing, tp_inputs, sharded_held, sharded_launched,
     ring_sets) = phase_sharded_training(
        dev, gpu, rate, train_losses,
        {"granite-3-2b": granite_tokens, "zamba2-2.7b": zamba2_tokens,
         "whisper-base": whisper_tokens}, t_start, lingam_want, engine_fits, profile)
    err_ring = phase_ring_block_kernel(dev, gpu, core["x"])
    launches_ring, launches_ring_upd, launches_ring_find_root, ring_want = phase_ring_ecoli(
        dev, gpu, profile)
    ring_launched, _ = report_ring_sharded(gpu, ring_sets, ring_want, profile)
    phase_ica_lingam(dev, gpu)
    phase_poly_scores(dev, gpu)
    launches_f64 = phase_fit_f64(dev, gpu, core)
    launches_b_f64 = phase_fit_batch_f64(dev, gpu)
    if profile:
        profile_fits(dev, gpu)
    tp_timing = phase_ssd_device_tp(gpu, tp_inputs, tp_timing)
    phase_dryrun_hold(gpu, train_held, sharded_held)
    sq_ms, sq_wrapper, sq_plain, sq_bound, sq_by = sq["ecoli_stage"]
    sqb_ms, sqb_wrapper, sqb_plain, sqb_bound, sqb_by, sqb_padded, sqb_shape = sq["batch"]
    say("smoke_wall", seconds=f"{time.perf_counter() - t_start:.1f}", gpu=f"'{gpu}'")
    print(json.dumps({"kernels": [{
        "name": "fused_score", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max(err_kernel, err_core, err_fit), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": "operations", "library_ms": None,
        "wrapper_ms": wrapper_ms, "shape": "p=512,n=2000,block=8",
        "launches_float64_fit": launches_f64, "gpu": gpu,
    }, {
        "name": "fused_score_batch", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": BATCH_REPLACES, "launches": launches_b, "max_abs_err": err_b,
        "ms": ms_b, "plain_ms": plain_b, "bound_ms": bound_b, "bound_by": "operations",
        "library_ms": None, "wrapper_ms": wrapper_b, "bound_ms_padded_buffer": padded_b,
        "launches_data_sharded_per_rank": sharded_launched["fused_score_batch"],
        "launches_float64_bucket": launches_b_f64, "shape": shape_b, "gpu": gpu,
    }, {
        "name": "pairwise_moments", "route": "cuda", "source": SQUARE_SOURCE,
        "replaces": SQUARE_REPLACES, "launches": launches_sq,
        "launches_ring": launches_ring, "launches_ring_find_root": launches_ring_find_root,
        "launches_ring_sharded_per_rank": {g: sq for g, (sq, _) in ring_launched.items()},
        "max_abs_err": max(err_sq, err_ring),
        "ms": sq_ms, "plain_ms": sq_plain, "bound_ms": sq_bound, "bound_by": sq_by,
        "library_ms": None, "wrapper_ms": sq_wrapper,
        "shape": "m=128,n=10000,the E. coli fit's first-stage mask",
        "ms_m512_n2000": sq["slice"][0], "plain_ms_m512_n2000": sq["slice"][2],
        "bound_ms_m512_n2000": sq["slice"][3], "gpu": gpu,
    }, {
        "name": "pairwise_moments_batch", "route": "cuda", "source": SQUARE_SOURCE,
        "replaces": SQUARE_REPLACES, "launches": launches_sqb, "max_abs_err": err_sq,
        "ms": sqb_ms, "plain_ms": sqb_plain, "bound_ms": sqb_bound, "bound_by": sqb_by,
        "library_ms": None, "wrapper_ms": sqb_wrapper, "bound_ms_padded_buffer": sqb_padded,
        "shape": sqb_shape, "gpu": gpu,
    }] + [{
        "name": name, "route": "cuda", "source": COV_SOURCE, "replaces": replaces,
        "launches": cov_launched[name], "max_abs_err": err, "ms": cov_timing[name][0],
        "plain_ms": cov_timing[name][1], "bound_ms": cov_timing[name][2], "bound_by": "bytes",
        "library_ms": None, "device_ms": cov_timing[name][4],
        "empty_kernel_device_ms": cov_timing[name][5], "shape": cov_timing[name][3],
        "gpu": gpu,
    } for name, replaces, err in (("update_data", DATA_REPLACES, max(err_data, path_ex)),
                                  ("update_cov", COV_REPLACES, max(err_cov, path_ec)))] + [{
        "name": "rank1_update", "route": "cuda", "source": COV_SOURCE,
        "replaces": RANK1_REPLACES, "launches": launches_upd,
        "launches_data_sharded_per_rank": sharded_launched["rank1_update"],
        "launches_ring": launches_ring_upd,
        "launches_ring_sharded_per_rank": {g: u for g, (_, u) in ring_launched.items()},
        "max_abs_err_ring_mode": err_ring_upd, "device_ms_ring_mode": ring_upd_timing[0],
        "plain_ms_ring_mode": ring_upd_timing[1], "bound_ms_ring_mode": ring_upd_timing[2],
        "empty_kernel_device_ms_ring_mode": ring_upd_timing[3],
        "shape_ring_mode": ring_upd_timing[4],
        "max_abs_err": err_rank1,
        "ms": rank1_timing[0], "plain_ms": rank1_timing[1], "bound_ms": rank1_timing[2],
        "bound_by": "bytes", "library_ms": None, "device_ms": rank1_timing[3],
        "empty_kernel_device_ms": rank1_timing[4], "shape": rank1_timing[5], "gpu": gpu,
    }] + [{
        "name": "ssd_decode", "route": "cuda", "source": SSD_SOURCE, "replaces": SSD_REPLACES,
        "launches": ssd_launches, "launches_zamba2": ssd_launches_zamba2,
        "max_abs_err": max(err_ssd, err_serve, err_zamba2), "ms": ssd_timing[0],
        "plain_ms": ssd_timing[1], "bound_ms": ssd_timing[2], "bound_by": "bytes",
        "library_ms": None, "device_ms": ssd_timing[4], "wrapper_ms": ssd_timing[5],
        "shape": ssd_timing[3], "max_abs_err_zamba2": err_zamba2, "ms_zamba2": zamba2_timing[0],
        "plain_ms_zamba2": zamba2_timing[1], "bound_ms_zamba2": zamba2_timing[2],
        "device_ms_zamba2": zamba2_timing[4], "shape_zamba2": zamba2_timing[3],
        "launches_zamba2_tp": launches_tp, "max_abs_err_zamba2_tp": err_tp,
        "ms_zamba2_tp": tp_timing[0], "plain_ms_zamba2_tp": tp_timing[1],
        "bound_ms_zamba2_tp": tp_timing[2], "device_ms_zamba2_tp": tp_timing[4],
        "shape_zamba2_tp": tp_timing[3], "gpu": gpu,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
