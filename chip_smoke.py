#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when it fails:

1. print the card's name and power limit (``nvidia-smi``); no CUDA, no run;
2. build the CUDA kernels from ``src/repro_torch/csrc``, one ``nvcc`` per
   source, all started together, and print the build seconds and
   ``ptxas``'s register and shared-memory report;
3. hold each kernel against its plain PyTorch version on the card: the
   paged kernels at qwen3-0.6b shapes (H 16, KV 8, D 128, BS 16, R 4, C 32;
   causal and local with window 64, bf16 and fp32, plus ragged heads H 6 /
   KV 4); flash attention forward and backward at the paper model's shape
   (B 4, S 1024, H = KV = 16, D 48) and at GQA 16/8 with D 128, ragged 6/4,
   causal, local (window 64) and full, D 128 and 256 at S 1024, D 36, bf16
   and fp32, each line naming the kernels that served it (bf16 with
   D % 8 == 0 the tensor-core ones, the rest the CUDA-core ones); the NoLoCo outer
   update on a leaf the size of the paper model's stacked embedding
   (4 × 128,000 × 768).  Then time kernel, plain version and the library
   yardstick (``scaled_dot_product_attention`` forward and backward, which
   the port never calls) at the shapes the main paths give them, the flash
   pair also on the kept CUDA-core kernels in bf16;
4. serve qwen3-0.6b at its published width in bf16 (14 of its 28 layers;
   phase 54 runs all 28) on weights from seed 0:
   8 requests, 4 slots, prompts 24/80/200, generation 16/32, 128 pages of
   16, chunked prefill 32, greedy.  Launch counts are zeroed just before the
   run and read just after; both kernels must have launched.  Two requests
   are decoded again alone and must give the same tokens, and one short
   request is served under ``torch.profiler`` to split its wall time into
   device busy time and the rest;
5. run one 40-token prompt plus 8 greedy decode steps of the full-width
   model (14 layers) in fp32 on the card (kernels) and on the CPU (plain versions), on
   the same weights: identical tokens, logits within fp32 tolerance;
6. train paper-small-125m at its published width in bf16 through
   ``run_training``: NoLoCo, 4 replicas, per-replica batch 4, seq 1024,
   5 inner steps, 10 steps (2 outer syncs).  Launch counts are zeroed just
   before and read just after, and must equal the counts the config implies
   (per step: one forward per layer, one more under remat, one backward per
   layer; per sync: one update per parameter leaf).  Every loss is finite,
   the last is below the first, the replicas' weight std is above 0.  Then
   the outer step is timed alone and one more inner step is profiled for
   the device's busy share;
7. train ``paper-small-125m.reduced()`` in fp32 (NoLoCo, 4 replicas, 2
   outer rounds) on the card and on the CPU from the same initial state:
   identical partner tables, per-step losses within 1e-4 relative, final
   weight std within 1e-3 relative;
8. (with phase 3) hold the int8 quantize and dequantize kernels against
   their plain versions bit for bit: fp32 and bf16 payloads, whole aligned
   chunks (the quantize kernel's 16-byte path), ragged tails, rows that do
   not start 16-byte aligned, N < CHUNK, constant chunks, chunk magnitudes
   from 1e-30 to 1e4, chunks of denormal range, quotients within 2 ulp of a
   half-integer, CHUNK 1024, 256, 2048, 3000 and 7, and the full-width
   payload (4 replicas × 366,477,312 bf16 values), each line naming the
   chunks that took the 16-byte path; time both there with L2 flushed,
   beside the plain versions and the bound (``time int8_quantize`` also
   carries ``scalar_ms``: the payload one element off alignment, every
   chunk on the scalar path);
9. train paper-small-125m at full width as in phase 6 with the int8 wire
   (``codec="int8"``): launch counts as the design implies (one quantize
   and one dequantize per float buffer of the payload per sync, all four
   replicas in one launch), ``comm_bytes`` equal to the byte model's, the
   losses and inner-step p50, and the outer step timed alone with the int8
   and the plain wire in turns on the same state;
10. phase 7 with the int8 wire: identical partner tables, losses within
    1e-4 relative (the weight std is reported: the int8 wire amplifies the
    last-bit differences of card and CPU);
11. checkpoint and resume on the card, reduced model in fp32 with the int8
    wire: 6 steps saving every 3, resumed to 12, against 12 uninterrupted
    steps: identical losses and bit-identical final θ, φ and δ; the save
    and the restore of that state timed;
12. promote replica 1's φ from that checkpoint and serve 4 greedy requests
    through ``repro_torch.launch.serve --ckpt`` on the card (paged kernels,
    launch counts > 0) and on the CPU: identical tokens;
13. (with phase 3) hold the recurrent families' kernels against their plain
    versions: the SSD chunk kernel at the serve shape (Q 32, H 32, P 64,
    N 128), at Q 1, 16, 64, 100 and 128, on ragged chunks with dt = 0 pad
    rows and at the training shape (B 16, NC 8, Q 128), where kernel and
    plain version are also held against an fp64 evaluation, and a (b, c)
    slice alone against the same slice batched, bit for bit;
    the RG-LRU scan at (1, 32, 4096), at S 1, 8, 24, 32 (loaded whole),
    33 and 1024 (the ring of step groups), W 4095, 4096, 4097 and other
    widths no multiple of 32, each line naming the library's launch (held
    against the plain rule: whole up to 32 steps); both decode steps at the
    serve shapes and ragged ones, their states bit for bit; and the paged kernels at
    recurrentgemma-9b's local layers (H 16, KV 1, D 256, window 2048) over
    contexts longer than the window.  Then time the four kernels at the serve shapes (the SSD
    decode step beside one PyTorch copy of its state, ``copy_ms``) and the
    two scans also at the training slice's shapes, and the paged kernels
    at recurrentgemma-9b's shape;
14. serve mamba2-370m (48 layers) and then recurrentgemma-9b (38) at
    published width and depth in bf16 with the phase-4 mix, each model freed before the next: tokens/s, TTFT
    and decode-step p50/p99, peak memory, every request's budget, batched
    == solo, and launch counts equal to the design (per prefill chunk and
    per decode step: one scan or decode step per recurrent layer, one paged
    kernel per attention layer); each profiled request also splits the
    recurrent kernels' card time by kernel (``recurrent_kernels_split``:
    the union of each kernel's spans and its launches);
15. both families' ``reduced()`` configs in fp32 on the card and on the CPU
    from the same weights, prompts of 80 and 200 tokens (the reduced window
    is 64): identical tokens, logits within 2e-3;
16. (with phase 3) the split paged kernels against their plain versions at
    qwen3-0.6b's and recurrentgemma-9b's shapes in bf16 and fp32, with the
    engine's table width, across split boundaries: contexts of 1, one key
    below, at and above a split boundary, 231, 2047 and 2048 with window
    2048, and windows whose first key falls inside a split (``check split``
    lines name each slot's split count); each slot of a 4-slot call against
    the same slot alone, bit for bit (``check slot alone == batched``).  The
    ``time paged_*`` lines carry the library's split plan
    (``keys_per_split``, ``grid_splits``, ``slot_splits``) and
    ``ms_one_tile`` (one split per slot);
17. (before phase 4) serve qwen3-0.6b (14 layers) with the phase-4 mix greedy and at
    temperatures 0.0/0.7 in turns, before any profiler has run (``serve
    qwen3-0.6b greedy and sampled in turns``: step p50/p99, tokens/s), and
    time the sampling draw of one decode step alone (4 rows of the
    151,936-token vocabulary: keys to the card, threefry bits, uniforms,
    Gumbel noise; ``time sampling draw``); (after phase 4) serve the mix at
    0.0/0.7 as phase 4 does (requests 1 and 5, held against their solo
    runs, are sampled): launch counts, batched == solo, and the profiled
    request at 0.7 beside the greedy one (``serve qwen3-0.6b sampled vs
    greedy``).

18. (after phase 6) phase 6's bf16 run again with the flash op on the kept
    CUDA-core kernels, profiled to show that only those kernels ran: step
    1's loss within FLASH_PAIR_STEP1_RTOL of the tensor-core run's, every
    later step's within FLASH_PAIR_LOSS_RTOL (``train bf16 flash pair``).

19. (with phase 3) the scans' backward kernels against their plain
    versions: ``rglru_scan_bwd`` bit for bit at recurrentgemma-9b's training
    shape (2, 1024, 4096), at (16, 1024, 4096) and on ragged steps and
    widths; ``ssd_chunk_bwd`` within SSD_BWD_RTOL (normwise) at mamba2-370m's
    training shape (16, 8, 128, 32, 64, N 128; there also against fp64), on
    a ragged sequence, at the reduced config's shape, with a (H,) and
    (B, H), Q 100 / 50 / 1 and P 33 / N 17, and across the 64-row tiles and
    64-deep steps of its tensor-core design (Q 256 with P 128; Q 130 with
    H 1, P 30, N 66, a per row; the library's tile and grid plan on each
    line); each
    called twice, bit for bit;
    the flash pair at recurrentgemma-9b's training shape (bf16, B 2, S
    1024, 16 heads of 256, KV 1, local, window 2048).  Then both timed
    beside their plain versions (no PyTorch call computes either) and
    beside the first designs' times (``was``);
20. train mamba2-370m at full width with 24 of its 48 layers (phase 6's run)
    and recurrentgemma-9b at full width with 3 layers (rglru, rglru, local:
    its three kinds) on 2 replicas × batch 1 × seq 1024, bf16 with remat,
    through ``run_training``: launch counts equal to the config's (each
    kernel over the layers of its kind; one scan launch per layer and pass
    for all replicas together), losses finite and falling, replicas apart
    (with two replicas, after the profiled steps: a sync gives both the same
    φ′), inner-step p50, peak memory, the profiled step's busy share and
    each scan kernel's ms (``recurrent_kernels_split``);
21. phase 7 for both families: ``reduced()`` in fp32 (recurrentgemma-9b at
    3 layers), NoLoCo on the card against the CPU: identical partner
    tables, losses within 1e-4, weight std within 1e-3; the card run is
    profiled and every kernel of the scans' wrappers, both backward kernels
    included, ran as many times as its wrapper counted.

22. (with phase 3) the flash pair and the paged pair at granite-moe-1b-a400m's
    heads (H 16, KV 8, D 64): flash at its training shape (B 8 = 2 replicas
    × batch 4, S 1024, causal), ragged and local, the paged pair causal and
    local, bf16 and fp32, against their plain versions; then timed there in
    bf16 beside SDPA and the bound (``time flash_attention at granite's
    training shape``, ``time paged_* at D 64``);
23. serve granite-moe-1b-a400m at its published width and depth in bf16
    (24 layers) with the phase-4 mix: launch counts equal to the design (one paged kernel per
    layer per chunk call and per decode step), every request's budget,
    tokens/s, TTFT and step p50/p99, peak memory, the profiled request; no
    solo re-decode (MoE capacity is shared by the rows routed together);
24. train granite-moe-1b-a400m at full width with 12 of its 24 layers (32
    experts, top-8) through ``run_training``: NoLoCo, 2 replicas × batch 4
    × seq 1024, 5 inner steps, 10 steps, as phase 6 (launch counts, losses
    finite and falling, replicas apart after the profiled steps, inner
    p50/p99, outer step alone, peak memory, the profiled step's busy share
    and top device ops); then one MoE layer's forward and backward timed
    alone at that shape, beside its expert products alone (``time moe
    block granite``: the rest is the eager routing, dispatch and combine);
25. card against CPU on ``reduced()`` in fp32, every MoE routing call of
    both runs recorded (``RoutingLog``): granite serving the phase-4 mix
    (identical tokens), granite NoLoCo training as phase 7 (partner tables,
    losses within 1e-4, weight std within 1e-3), and one loss-and-gradient
    evaluation each of gemma-2b, stablelm-1.6b, minitron-8b and
    qwen3-moe-235b-a22b (loss within 1e-4, gradients within 1e-4 normwise);
    the routing decisions that differ are counted (0 expected), and any
    must be a near tie (top-k margin under 1e-5): the losses and tokens are
    then held up to it.

26. (with phase 3) the flash pair at the encoder-decoder and vision
    models' shapes against its plain versions, bf16 and fp32, each line
    naming the kernels that served it: whisper-base's encoder (B 16 =
    4 replicas × batch 4, 1,500 frames, 8/8 heads of 64, full), its
    cross-attention (448 queries over 1,500 keys, full) and decoder (448,
    causal), internvl2-76b's layers (1,024, 64/8 heads of 128, causal), and
    full mode at Sq 1 / Sk 37 and Sq 5 / Sk 1,500; then the first four
    timed in bf16 beside the CUDA-core kernels, the plain version, SDPA
    and the bound (``time flash_attention* B16 S448/Sk1500 ...``);
27. whisper-base at full width and depth (6 + 6 layers) in bf16 on seed-0
    weights: NoLoCo through ``GossipProgram`` (``core/noloco.GossipTrainer``
    with ``model.stacked_loss``) on 4 replicas × batch 4, 1,500 stub frames
    and 448 text tokens a row, phase 6's outer settings: launch counts
    equal the design's (per step one flash forward per encoder layer and
    two per decoder layer, twice under remat, one backward each; one
    update per leaf a sync), losses finite and falling, replicas apart;
    inner p50/p99, text tokens/s, the outer step alone, peak memory, the
    profiled step's busy share, top ops and flash ms by call
    (``flash_ms_by_mode``); then served from the dense cache (4 rows,
    4-token prompts, a cache of 448, ``prefill`` and 64 greedy
    ``decode_step``s): prefill ms, step p50/p99, tokens/s, peak memory,
    the prefill's flash launches, and the cross-attention's plain
    blockwise calls in one more step (their span on the stream, and the
    function alone per layer);
28. internvl2-76b at full width with 2 layers (3.84 B parameters) in bf16,
    seed-0 weights drawn on the card layer by layer into the stacked tree:
    one loss and gradient on 256 stub patch embeddings and 768 text
    tokens (finite, gradient norm above 0, flash launches as the design),
    then a dense prefill of the image and 32 tokens and 16 greedy steps;
    times and peak memory;
29. card against CPU on ``reduced()`` in fp32: whisper-base's and
    internvl2-76b's loss and gradients (LOSS_RTOL, GRAD_NORM_RTOL), dense
    greedy tokens identical for whisper-base, internvl2-76b, qwen3-0.6b,
    recurrentgemma-9b and mamba2-370m (logits within LOGIT_ATOL; each
    kernel the dense path reaches launched: flash in prefill, the scans in
    prefill, the decode steps), and a whisper-base NoLoCo run of 10 steps
    (identical partner tables, losses within LOSS_RTOL).

30. paper-small-125m at full width (6 of its 12 layers) in bf16 on 8
    replicas × batch 2 × seq
    1024 through ``launch.train_elastic.run_elastic_training`` (m 5, 50
    steps, an eval of one batch every 5) under a fault plan: replicas 3
    and 5 drop at round 2 and rejoin at round 5, warm-started from replica
    0; replica 1 straggles at round 6; a partition into two halves at round
    7 heals at round 9.  Launch counts equal ``expected_launches`` (every
    inner step one batched forward and backward over all 8 replicas, frozen
    ones included; every round one update per leaf) plus the evals'
    forwards; losses finite and falling; rounds 2–4 pair 6 replicas and
    leave 3 and 5 alone; the partition's rounds never pair across the cut;
    the final membership is epoch 2 with all 8; the dropped replicas' θ, φ,
    δ, moments and step count bit-identical (row checksums) from the drop
    to the rejoin, and after it θ = φ = the source's φ with zero δ,
    moments and count.  Inner step p50/p99 by phase (full, masked,
    partitioned), the outer step by round kind, the warm start, peak
    memory, losses, weight std at every eval, the rounds; then
    ``profile_steps`` on the final state (the full outer step alone, the
    profiled step's busy share);
31. the 2× straggler (replica 1 at rate 0.5 from round 0, ``stale=
    "momentum"``) at phase 30's width, m 4, 24 steps: ``max_staleness`` 1,
    ``blocked_syncs`` 0, each merged tick's table an involution over its
    participants, launch counts as designed; the merged ticks' ms beside
    the synchronous outer step (``time_outer`` on the final state); then a
    rate-1 world (``async_clock=True``, 8 steps) against the synchronous run
    of the same steps: losses and final θ bit-identical under both stale
    rules;
32. card against CPU on ``reduced()`` in fp32 (8 × 2 × 64): phase 30's and
    phase 31's plans give identical round histories, losses within
    LOSS_RTOL and weight std within WSTD_RTOL; then on the card a resume
    mid-straggle (the debt outlives the first run's 8 steps) and one
    mid-async (step 13), each bit-identical to its uninterrupted run.

33. paper-small-125m at full width in bf16 through ``run_training`` with
    streaming outer steps: phase 6's run (4 × 4 × 1024, m 5) for 15 steps
    with 4 staggered streams and the φ-prefetch overlap, on the plain and
    the int8 wire.  The syncs fall at steps 5–8, 10–13 and 15 on streams
    0–3, 0–3, 0; each stream's first sync blocks and the later ones consume
    their prefetch (``stream_sync`` events); each sync's bytes are the byte
    model's; stream 0 holds no leaf, moves 0 bytes and launches nothing;
    launch counts as designed (the flash pair as phase 6, one update per
    leaf of the synced stream: 26, and on the int8 wire one quantize and
    one dequantize per buffer of what each sync moves and of its pre-send);
    losses finite and falling.  Inner step p50/p99, each stream's sync in
    the run and alone, a cycle of four syncs (blocking, then consuming)
    against one full outer step on the same state (``time_outer``), each
    φ′ pre-send alone, peak memory.  Then one stream with the overlap at
    phase 6's own run gives phase 6's losses bit for bit;
34. the streamed run through churn at full width (8 × 2 × 1024, m 4, 4
    streams, 28 steps; replica 3 drops at step 9 and rejoins at step 17)
    through ``run_elastic_training``: each stream falls back to the
    blocking exchange at most once per membership change, at least one
    does, none before the first change; the dropped replica self-paired
    while out; launches as designed; losses finite;
35. card against CPU on ``reduced()`` in fp32: the streamed run on both
    wires and the streamed churn (identical ``stream_sync`` events,
    partner tables and rounds, losses within LOSS_RTOL, weight std within
    WSTD_RTOL), ``core/theory.py``'s ``simulate_quadratic`` synchronous and
    with a 2× slow replica (trajectories within THEORY_RTOL; on the card
    every outer step launches ``noloco_update``), and a resume mid-stream
    on the card (step 7, the prefetch in the checkpoint), bit-identical to
    the uninterrupted run;
36. the routed pipeline (§3.1 random routing between stage replicas, the
    per-stage gossip outer step): paper-small-125m at full width in bf16,
    2 stages × 4 replicas, 4 × 1024 a replica, NoLoCo m 5, 15 steps through
    ``make_loop(PipelineProgram(...))``, on the plain and the int8 wire:
    launches as designed (``PIPE_DESIGN``: the flash pair 360 / 180, 24
    updates a sync, on int8 a quantize and a dequantize per float buffer of
    each stage's payload, 4 a sync), ``comm_bytes`` the byte model's
    (1,126,477,824 B a sync; int8 567,561,816), routes permutations that
    vary, losses finite and falling; inner step p50/p99 and each outer step
    in the run (``PipeProbe``, synchronised), one outer step alone, peak
    memory, and one profiled inner step: busy share, the top device ops,
    the route gathers' forward (``index_select``) and backward
    (``index_add_``) in the step and alone;
37. 4 stages of 3 layers, the plain wire, 10 steps: 44 updates a sync, the
    flash pair's launches per step as phase 36's, stages 1 and 2 holding
    neither the embedding nor the unembedding; the same times;
38. card against CPU on ``reduced()`` in fp32 from the same initial weights:
    NoLoCo on both wires and ``method="none"`` with fixed routing
    (identical routes and partner tables, losses within LOSS_RTOL, weight
    std within WSTD_RTOL on the plain wire), the elastic drop of replica 2
    (``tests/test_elastic.py``'s scenario; the dropped replica's rows on
    the card bit-identical from the drop on), a resume at step 6 on the
    card bit-identical to the uninterrupted run, and one loss and gradient
    of recurrentgemma-9b's ``reduced()`` in 2 stages (``rglru_scan`` and
    its backward launched; within LOSS_RTOL and GRAD_NORM_RTOL).

39. single-shot prefill (``prefill_chunk=0``): qwen3-0.6b and mamba2-370m
    at full width in bf16 with the phase-4 mix, then in fp32 with its first
    four requests, chunked and single-shot on the same weights: the same
    tokens (fp32: no flip; a bf16 flip printed with its request, index and
    the chunked run's top-two margin, which must be a near tie), the
    single-shot launches as the design's (``flash_attention`` 14 × 8 for
    qwen3-0.6b at 14 of its 28 layers, ``ssd_chunk`` 24 × 8 for mamba2-370m
    at 24 of 48, no
    ``paged_chunk_attention``), TTFT p50/p99 beside the chunked run's;
40. speculative decode at full width in bf16, spec_k 4, the phase-4 mix's
    first four requests, against the plain engine on the same weights
    (the targets at 14 of qwen3-0.6b's 28 layers, 24 of mamba2-370m's 48,
    20 of recurrentgemma-9b's 38): qwen3-0.6b with itself as the draft
    (``accept_rate`` 1.0 unless a flip shows) and with its first 7
    layers, greedy and at temperatures 0.0/0.7; mamba2-370m with 12
    layers; recurrentgemma-9b with 9 (``rglru_decode``
    and the local paged path).  Launches as the design's (a round: spec_k
    decode-kernel launches per layer of the draft and of the target's
    verify; a prefill chunk: one chunk call per layer of both), tokens/s,
    rounds, ``accept_rate`` and peak memory beside the plain run's; every
    bf16 flip printed as in phase 39; then each family's truncated draft in
    fp32 at full width (no flip);
41. ``launch.serve --ckpt <phase 11's checkpoint> --replica 1 --spec-decode
    --draft-replica 2 --verify`` on the card and on the CPU: no mismatch
    against the plain engine, card tokens equal CPU tokens;
42. the router: two qwen3-0.6b engines (14 layers) on seed-0 and seed-1
    weights on one
    card, both policies: placement as the policy's rule, each request's
    tokens those of its engine alone;
43. card against CPU on the three families' ``reduced()`` configs in fp32:
    speculative tokens, rounds and ``accept_rate`` equal (and equal to the
    card's plain engine), single-shot tokens equal.

44. the replica group (``launch/train_distributed.py``, one rank per
    replica over ``torch.distributed``): paper-small-125m at full width in
    bf16 (6 of its 12 layers, as in 49–51) on 4 ranks spawned on this card over gloo (the payload staged
    through pinned host memory), each rank through ``run_rank``, the CLI's
    per-rank body: 4 × 1024 a rank, m 5, 10 steps, NoLoCo on the plain and
    the int8 wire, and DiLoCo.  Every rank's launches (zeroed just before
    its run, read just after, sent back to this process) equal phase 6's
    design for one replica (DiLoCo: no ``noloco_update``); losses finite and
    falling; the ranks agree on the partners.  Per rank: inner step
    p50/p99, the outer step alone (three times on the final state, split by
    a synchronising clock into encode, D2H, wire, H2D, decode and update),
    peak memory, and the card's use with all four ranks resident;
45. fp32 ``reduced()`` on the ranks on the card and on the CPU (a CPU view
    of the same group): identical partner tables, losses within LOSS_RTOL,
    weight std within WSTD_RTOL, the training kernels launched;
46. a resume on the card (``reduced()``, int8 wire): 5 steps saved by rank 0,
    resumed to 10, bit-identical to 10 straight steps on every rank;
47. the counted outer step (from phase 44's runs): a NoLoCo sync is one
    batched send/receive carrying exactly the byte model's payload and no
    ``all_reduce``; a DiLoCo sync one ``all_reduce`` per buffer of Δ, each
    in its dtype, handing over exactly the bytes of Δ (the byte model's
    ring bytes are 2(w-1)/w of them); inner steps make no cross-rank call;
48. the plain run with one rank a card, over NCCL and over gloo, where the
    machine shows two cards or more (else a line says why it did not run;
    ``dist_cards_phase`` runs it alone), and with four cards phase 51's
    plain streamed run over NCCL (else a line says why not); then the CLI,
    ``python -m repro_torch.launch.train_distributed --reduced``, on the
    card: its summary names the card and the backend;
49. elastic rounds on the replica group (one more spawn of 4 ranks on this
    card over gloo runs 49–52, each rank under its own ``SimCluster`` from
    the same plan): paper-small-125m at full width in bf16 (6 layers), 4 ×
    1024 a rank, m 5, 35 steps; drop [3] at round 1, rejoin [3] at round 3 from
    replica 0, straggle [1] one round at round 4, partition [[0, 1], [2,
    3]] at round 5, heal at round 6.  The ranks agree on the rounds and
    they are the plan's; rank 3's rows (checksums of every leaf and the
    count) are the same at its drop and before its rejoin; its θ and φ
    after the warm start are the source's φ bit for bit, δ and the moments
    zero; the warm start is one send on rank 0 and one receive on rank 3
    and no call elsewhere; each step a rank takes launches the design's
    flash pair and a step it sits out nothing, each sync one update per
    leaf on a rank that takes part and none otherwise, and no sync
    all-reduces; losses finite.  Per rank: inner p50/p99, each round's
    outer step, the warm start's time and bytes, peak memory;
50. the 2× straggler (rank 1 at rate 0.5, ``stale="momentum"``, m 4, 24
    steps): ``max_staleness`` 1, ``blocked_syncs`` 0, rank 1 sits half the
    steps out, launches as in 49; a rate-1 world (8 steps of ``reduced()``
    in fp32) equals the synchronous run bit for bit (losses, every rank's
    rows);
51. 4 streams with the overlap, each stream's φ′ pre-send posted without a
    wait and waited at its next sync: phase 33's schedule (4 × 1024, m 5,
    15 steps) on the plain and the int8 wire.  Each stream's first sync
    blocks and the later ones consume; each sync's blocking part and each
    pre-send move the byte model's bytes; launches as designed.  Every
    sync is split by a synchronising clock: the blocking exchange (encode,
    D2H, wire, H2D, decode), the update, the pre-send's post and the wait
    on the φ′ pre-sent at the stream's last sync; then on the final state
    phase 44's full outer step and cycles of four stream syncs, the same
    wire.  Then the streamed churn (m 4, 28 steps, rank 3 out over steps
    9–17): at most one fallback per stream per membership change;
52. the plans of 49, 50 and 51's churn on ``reduced()`` in fp32, on the card
    and on a CPU view of the same ranks: identical rounds, partner tables
    and ``stream_sync`` events, losses within LOSS_RTOL, weight std within
    WSTD_RTOL; on the card a resume mid-straggle (step 13) and one
    mid-stream (step 11, every pre-send in flight), each bit-identical to
    its uninterrupted run.

53. the model axis (``dist_tp_phase``): paper-small-125m at full width in
    bf16 on 2 replicas × 2 model ranks (``--data 2 --model 2``, 4 ranks
    sharing the card over gloo, each model-axis collective staged through
    pinned host memory), NoLoCo, m 5, 10 steps, 4 × 1024 a replica, on the
    plain and the int8 wire.  Per rank: launches as phase 44's design (a
    rank runs every layer's kernels on its heads), inner p50/p99, peak
    memory, the outer step alone split by the clock, flash launches, the
    model axis's calls and bytes of every inner step held equal to the
    design's count (``model_axis_calls``: forward 2L + 4,
    backward 2L + 3, one all-reduce of the whole leaves' gradients per
    dtype, one of the clipping norm, and L more under remat: the
    recomputation stops before each layer's MLP output), its
    all-reduce's ms at the MLP output's shape.  Losses finite and falling,
    a replica's ranks agree on them, the step-1 loss within TP_STEP1_RTOL
    and every loss of the first inner period (steps 1–5) within
    TP_PERIOD_RTOL of the same run's at ``--model 1`` from the same weights
    (2 ranks), the partner tables that run's.  Then ``reduced()`` in fp32 on the card and on a CPU view of
    the same ranks (losses within LOSS_RTOL, identical partner tables) and
    a resume on the card from a step-5 checkpoint, bit-identical to the
    straight run.  Phase 48 adds, on two cards or more, phase 53's plain
    run over NCCL, one rank a card;
54. the sequence-sharded serving steps (``dist_tp_decode_phase``):
    qwen3-0.6b in fp32 at ``--data 1 --model 2`` (2 ranks sharing the
    card, ``kv_shard_seq``: heads whole, each global layer's cache split
    by sequence) through ``build_prefill_step`` + ``build_decode_step``, 4
    rows, 32-token prompts, a cache of 256, 32 greedy steps: the tokens
    equal the unsharded ``model.prefill`` / ``decode_step`` run's on the
    card, logits within LOGIT_ATOL, one flash launch per layer in the
    prefill; the step p50 beside the unsharded one;
55. the ``fsdp_hybrid`` plan (``dist_fsdp_phase``): paper-small-125m at
    full width and depth in bf16 on 2 pods × 2 data ranks (4 ranks sharing
    the card over gloo, built through the trainer API with
    ``make_plan("fsdp_hybrid", 2, pod=2)``): each pod one replica whose
    weights are split ZeRO-3 style over its data ranks and gathered at use,
    each data rank training on its 2 of the replica's 4 × 1024 rows, NoLoCo
    m 5, 10 steps.  Per rank: launches as phase 44's design, the data
    axis's calls and bytes of every inner step held equal to the design's
    count from the leaves split on ``"fsdp"`` (``data_axis_design``), its
    resident state (θ, both moments, φ, δ) equal to the shard shapes'
    bytes, each sync's bytes equal to the byte model's cost of its shards
    (a pod's two ranks together: the replica's payload plus a second copy
    of the leaves held whole over the data axis), one send/receive a sync
    and no replica-axis call inside an inner step; inner p50/p99, the data
    axis's share of an inner step, the outer step alone split by the
    clock, peak memory.  Against the same run under ``gossip_dp``, phase
    53's ``--model 1`` run (2 ranks, one a replica, the same weights and
    batches): the partner tables, the step-1 loss within TP_STEP1_RTOL and
    steps 1–5 within TP_PERIOD_RTOL, its peak memory beside.

``time rglru_decode`` also carries ``launch_floor_ms``: an empty kernel
(``torch.cuda._sleep(0)``) timed by the kernel table's own method.

The line before the last is the ``kernels`` JSON record (launches: the
serve and train phases', phases 33, 34, 36, 37, 39, 40 and every rank's of
phases 44, 49–51, 53–54 and 55, "dist-tp" and "dist-fsdp", added); the
last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.checkpoint import ckpt as ckpt_lib  # noqa: E402
from repro_torch.comm import CommConfig, bytes_model, exchange, payload  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    granite_moe_1b, internvl2_76b, mamba2_370m, paper_llama, qwen3_0_6b, recurrentgemma_9b,
    registry, whisper_base,
)
from repro_torch.core import metrics as metrics_lib  # noqa: E402
from repro_torch.core import pairing  # noqa: E402
from repro_torch.core.elastic import ElasticContext  # noqa: E402
from repro_torch.core.outer import OuterConfig  # noqa: E402
from repro_torch.data import LoaderConfig, shard_iterator  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    build, dispatch, flash_attention, ops, paged_attention, quantize, ref, rglru_scan, ssd_scan,
)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.train_elastic import run_elastic_training  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.serve import serve_run, synth_requests  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.attention import PagedView  # noqa: E402
from repro_torch.models.layers import logits_sharded  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ReplicaRouter, ServeConfig, ServeEngine, SpecServeEngine, truncate_layers,
)
from repro_torch.sim import FaultPlan  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.pipeline import PipelineTrainer, split_stages  # noqa: E402
from repro_torch.train import LoopConfig, adapters, make_loop  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate and per-type compute.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# The special-function units' exp2 rate: 16 per clock per SM, 132 SMs.
EX2_PER_CLOCK = 16 * 132

# Tolerances of the kernel checks.  fp32: the kernel and the plain version
# sum in different orders.  bf16: both round an fp32 result to bf16, so they
# may differ by one bf16 ulp of the output (2**-6 for |out| in [2, 4)).
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Whole-model fp32 logits, card vs CPU: 28 layers of sums in another order.
LOGIT_ATOL = 2e-3
# bf16 attention gradients also get a relative tolerance: dK/dV sum over
# every query row and grow with it, while bf16 rounding is relative.
GRAD_RTOL = {torch.float32: 0.0, torch.bfloat16: 2e-2}
# Training, card against CPU (fp32): per-step losses and final weight std.
LOSS_RTOL, WSTD_RTOL = 1e-4, 1e-3
PAGED = ("paged_attention", "paged_chunk_attention")
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "noloco_update")
INT8 = ("int8_quantize", "int8_dequantize")
# One replica's (Δ, φ) payload of paper-small-125m at full width: its bf16
# buffer (the fp32 one holds the 76,800 norm values).
PAYLOAD_BF16 = 366_477_312
# The paper model's training shapes: 4 replicas × batch 4 folded into B.
PAPER = dict(b=16, s=1024, h=16, kv=16, d=48)

RECURRENT = ("ssd_chunk", "rglru_scan", "rglru_decode", "ssd_decode")
# their CUDA kernels' names, as the profiler reports them
RECURRENT_KERNELS = tuple(f"{name}_kernel" for name in RECURRENT)
# SSD chunk kernel against its plain version: fp32 sums of up to Q·N
# products in another order.
SSD_ATOL = SSD_RTOL = 1e-4
# The scans' backward kernels.  The RG-LRU one repeats the plain version's
# autograd arithmetic, rounding for rounding: bit for bit.  The SSD one is
# held normwise: each of dx, ddt, da, dB and dC within SSD_BWD_RTOL of that
# output's largest magnitude, of the plain version and, at the training
# shape, of an fp64 evaluation.  Its sums run in other orders (dB and dC
# over every head, ddt through a reverse cumsum of row and column sums
# that cancel), so an elementwise bound would measure the cancellation.
# The plain version's own distance from fp64, reported beside the
# kernel's, is of order 1e-5 (fp32 sums of up to Q·N and H·Q terms):
# 1e-4 leaves ~10×.
SSD_BWD_RTOL = 1e-4
RECURRENT_BWD = ("ssd_chunk_bwd", "rglru_scan_bwd")
# The first designs of the two backwards (CUDA-core products; a register
# ring of 16-step groups) at the timed shapes, ms, as this script measured
# them on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md's kernel table):
# the times the tensor-core and shared-memory-ring designs are read against
FIRST_BWD_MS = {"ssd_chunk_bwd": 4.327296, "rglru_scan_bwd": 0.345696, "rglru_scan_bwd_16": 0.590752}
# a hand-written kernel's name in a profiler event
KERNEL_NAME = re.compile(r"(?:flash|ssd|rglru)_\w*?kernel")

# Depth cuts that keep the script inside its time limit as phases are added
# (each keeps every layer kind, every launch design and every kernel check;
# PERF.md lists them with the seconds they saved): single-shot serving
# (phase 39), mamba2-370m's training (phase 20), granite's training (phase
# 24), qwen3-0.6b's serve runs (4, 5, 17, 42), speculative decode (40), the
# stacked elastic runs (30, 31) and the replica group's (44–52).  Phase 14
# serves mamba2-370m and recurrentgemma-9b at their published depth, phase 23
# granite, and phase 54 runs qwen3-0.6b's 28 layers (fp32, sequence-sharded).
SINGLE_SHOT_LAYERS = {"qwen3-0.6b": 14, "mamba2-370m": 24}
# qwen3-0.6b in phases 4, 5, 17 and 42 (the serve runs, card vs CPU, the router)
QWEN3_LAYERS = 14
# paper-small-125m in the stacked elastic and asynchronous runs (phases 30–31)
# and on the replica group (phases 44–52; phases 53 and 55 keep all 12)
ELASTIC_LAYERS = DIST_LAYERS = 6
MAMBA2_TRAIN_LAYERS = 24
GRANITE_TRAIN_LAYERS = 12


def dist_cfg():
    """paper-small-125m as the replica group's phases 44–52 train it."""
    return cut(paper_llama.SMALL, DIST_LAYERS)


def cut(cfg, layers: dict | int):
    """``cfg`` at the depth ``layers`` gives it (a dict by name, or an int)."""
    n = layers.get(cfg.name, cfg.num_layers) if isinstance(layers, dict) else layers
    return dataclasses.replace(cfg, num_layers=n)


H, KV, D, BS, R, C, WINDOW = 16, 8, 128, 16, 4, 32, 64
NUM_PAGES = 128
SPIN_CYCLES = 4_000_000              # ~2 ms at the H100's boost clock
DECODE_POS = [231, 111, 47, 215]     # context lengths of the serve phase's mix
CHUNK_BASE = [0, 32, 64, 168]        # chunk starts of 24/80/200-token prompts


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_inputs(gen, *, chunk, dtype, h=H, kv=KV, r=R, positions=None, d=D):
    """Pools of NUM_PAGES pages plus trash, each slot owning its own pages in
    a random order; table entries past a slot's pages are stale ids of other
    slots or trash, as an engine that has evicted requests leaves them."""
    dev = gen.device
    pos = positions if positions is not None else (CHUNK_BASE if chunk else DECODE_POS)[:r]
    last = [p + (C - 1 if chunk else 0) for p in pos]
    perm = torch.randperm(NUM_PAGES, generator=gen, device=dev).to(torch.int32)
    tables = torch.full((r, NUM_PAGES), NUM_PAGES, dtype=torch.int32, device=dev)
    start = 0
    for i, t in enumerate(last):
        n = t // BS + 1
        tables[i, :n] = perm[start:start + n]
        stale = (torch.arange(4, device=dev) + start + n) % NUM_PAGES
        tables[i, n:n + 4] = perm[stale]
        start += n
    qshape = (r, C, h, d) if chunk else (r, h, d)
    q = torch.randn(qshape, generator=gen, device=dev).to(dtype)
    kp = torch.randn((NUM_PAGES + 1, BS, kv, d), generator=gen, device=dev).to(dtype)
    vp = torch.randn((NUM_PAGES + 1, BS, kv, d), generator=gen, device=dev).to(dtype)
    return q, kp, vp, tables, torch.tensor(pos, dtype=torch.int32, device=dev)


def check_paged_case(gen, name, dtype, mode, window, h, kv, d=D, label="") -> float:
    """One paged kernel on pools of NUM_PAGES pages against its plain
    version; returns the max abs error."""
    op = dispatch.registry()[name]
    args = kernel_inputs(gen, chunk=name == "paged_chunk_attention", dtype=dtype, h=h, kv=kv, d=d)
    got = op.kernel(*args, mode=mode, window=window)
    torch.cuda.synchronize()
    want = op.plain(*args, mode=mode, window=window)
    if got.dtype != dtype or got.shape != args[0].shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    ok = math.isfinite(err) and err <= ATOL[dtype]
    log(f"check {name}{label} {str(dtype)[6:]} {mode} H{h}/KV{kv}{'' if d == D else f' D{d}'}: "
        f"max_abs_err {err:.3e} (atol {ATOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def check_kernels(dev) -> dict[str, float]:
    gen = torch.Generator(device=dev).manual_seed(1)
    errors = {}
    for name in PAGED:
        errors[name] = max(
            check_paged_case(gen, name, dtype, mode, window, h, kv)
            for dtype in (torch.bfloat16, torch.float32)
            for mode, window, h, kv in (("causal", 0, H, KV), ("local", WINDOW, H, KV),
                                        ("causal", 0, 6, 4)))
    return errors


def cuda_ms(fn, reps: int = 100) -> tuple[float, float]:
    """Median device time of ``fn`` over ``reps`` calls, and the SM clock the
    card ran at meanwhile.  L2 is flushed before each call (every layer has
    its own pools, so the engine finds them cold).  A spin of SPIN_CYCLES on
    the stream holds the device while the host enqueues the start event,
    ``fn``'s launches and the end event, so the host's own time to launch is
    not counted; the spin's own duration gives the clock in MHz."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(5):
        fn()
    times, spins = [], []
    for _ in range(reps):
        flush.zero_()
        s0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s0.record()
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        spins.append(s0.elapsed_time(a))
    return statistics.median(times), SPIN_CYCLES / statistics.median(spins) / 1e3


def sdpa_inputs(q, kp, vp, tables, positions, chunk):
    """Dense per-slot K/V gathered through the tables, heads expanded, with
    the positional mask: what one library attention call needs."""
    r = tables.shape[0]
    c = q.shape[1] if chunk else 1
    h, (kv, d) = q.shape[-2], kp.shape[-2:]
    t = int(positions.max()) + c
    blocks = -(-t // BS)
    idx = tables[:, :blocks].long()
    k = kp[idx].reshape(r, blocks * BS, kv, d)[:, :t]
    v = vp[idx].reshape(r, blocks * BS, kv, d)[:, :t]
    g = h // kv
    k = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()   # (R, H, T, D)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    qd = (q if chunk else q[:, None]).transpose(1, 2).contiguous()  # (R, H, C, D)
    q_pos = positions[:, None].long() + torch.arange(c, device=q.device)[None]
    mask = torch.arange(t, device=q.device)[None, None] <= q_pos[:, :, None]  # (R, C, T)
    return qd, k, v, mask[:, None]


def bound(q, kp, positions, chunk, kv=KV, d=D):
    """Least time for the work: every live K/V entry, q and out moved once
    (plus the live table entries and positions), against 4·D flops per (query
    row, visible key)."""
    esz = q.element_size()
    c = q.shape[1] if chunk else 1
    h = q.shape[-2]
    live_keys = sum(p + c for p in positions.tolist())
    live_pages = sum(-(-(p + c) // BS) for p in positions.tolist())
    nbytes = 2 * live_keys * kv * d * esz + 2 * q.numel() * esz + 4 * (live_pages + len(positions))
    visible = sum((p + 1 + p + c) * c / 2 for p in positions.tolist())  # causal rows
    flops = 4 * d * h * visible
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[q.dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_inputs(gen, b, s, h, kv, d, dtype, sk=None):
    """q, k, v, dO; Sk = ``sk`` keys (default S)."""
    dev = gen.device
    sk = s if sk is None else sk
    shapes = [(b, s, h, d), (b, sk, kv, d), (b, sk, kv, d), (b, s, h, d)]
    return [torch.randn(sh, generator=gen, device=dev).to(dtype) for sh in shapes]


def _close(got, want, atol, rtol, what):
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    diff = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool(
        (diff <= atol + rtol * want.float().abs()).all())
    return diff.max().item(), ok


def check_flash_case(gen, dtype, b, s, h, kv, d, mode, window, errors, label="", sk=None) -> None:
    """Flash forward (o and lse) and backward of one case (S queries over
    ``sk`` keys, default S) against their plain versions; the worst error of
    each kernel goes into ``errors``."""
    reg = dispatch.registry()
    q, k, v, do = flash_inputs(gen, b, s, h, kv, d, dtype, sk)
    o, lse = reg["flash_attention"].kernel(q, k, v, mode=mode, window=window)
    grads = reg["flash_attention_bwd"].kernel(q, k, v, o, lse, do, mode=mode, window=window)
    torch.cuda.synchronize()
    o_want, lse_want = reg["flash_attention"].plain(q, k, v, mode=mode, window=window)
    g_want = reg["flash_attention_bwd"].plain(q, k, v, o, lse, do, mode=mode, window=window)
    results = [("flash_attention", *_close(o, o_want, ATOL[dtype], 0, "o")),
               ("flash_attention", *_close(lse, lse_want, 1e-4, 1e-5, "lse"))]
    results += [("flash_attention_bwd", *_close(g, w, ATOL[dtype], GRAD_RTOL[dtype], n))
                for g, w, n in zip(grads, g_want, ("dq", "dk", "dv"))]
    for name, err, ok in results:
        errors[name] = max(errors.get(name, 0.0), err)
        if not ok:
            raise AssertionError(
                f"{name} disagrees with its plain version: {str(dtype)[6:]} B{b} S{s} "
                f"Sk{k.shape[1]} H{h}/KV{kv} D{d} {mode}: max_abs_err {err:.3e}")
    keys = "" if sk is None else f"/Sk{sk}"
    log(f"check flash{label} {str(dtype)[6:]} B{b} S{s}{keys} H{h}/KV{kv} D{d} {mode} "
        f"path {flash_attention.path_for(dtype, d)}: "
        + ", ".join(f"{n} {e:.3e}" for n, e, _ in results) + " ok")


def check_train_kernels(dev) -> dict[str, float]:
    """Flash forward (o and lse) and backward, and the outer update, against
    their plain versions on the card."""
    gen = torch.Generator(device=dev).manual_seed(3)
    reg = dispatch.registry()
    errors = {name: 0.0 for name in TRAIN_KERNELS}
    cases = [(4, 1024, 16, 16, 48, "causal", 0), (2, 300, 16, 8, 128, "causal", 0),
             (2, 200, 6, 4, 48, "causal", 0), (2, 333, 16, 16, 48, "local", 64),
             (2, 257, 16, 8, 64, "full", 0), (1, 1024, 8, 8, 128, "causal", 0),
             (1, 1024, 4, 2, 256, "causal", 0), (2, 300, 8, 4, 36, "causal", 0)]
    for dtype in (torch.bfloat16, torch.float32):
        for case in cases:
            check_flash_case(gen, dtype, *case, errors)
    op = reg["noloco_update"]
    coef = dict(alpha=0.5, beta=0.7, gamma=0.9186)
    for dtype, mant in ((torch.bfloat16, 7), (torch.float32, 23)):
        args = [torch.randn((4, 128_000, 768), generator=gen, device=dev).to(dtype) for _ in range(4)]
        got = op.kernel(*args, **coef)
        torch.cuda.synchronize()
        want = op.plain(*args, **coef)
        for g, w in zip(got, want):   # within one ulp of the dtype
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"noloco_update: {g.dtype} {tuple(g.shape)}")
            ulp = torch.exp2(torch.floor(torch.log2(w.float().abs().clamp_min(1e-30))) - mant)
            diff = (g.float() - w.float()).abs()
            err = diff.max().item()
            errors["noloco_update"] = max(errors["noloco_update"], err)
            if not bool((diff <= ulp).all()):
                raise AssertionError(f"noloco_update {dtype}: off by more than 1 ulp ({err:.3e})")
        log(f"check noloco_update {str(dtype)[6:]} (4, 128000, 768): max_abs_err "
            f"{errors['noloco_update']:.3e} (1 ulp) ok")
        del args, got, want
    return errors


def flash_bound(b, s, h, kv, d, esz, backward, sm_mhz, sk=None, mode="causal"):
    """Least time for attention of S queries over ``sk`` keys (default S),
    causal or full, the largest of three: q, k, v (and o, dO) read once and
    the outputs written once; the flops of the visible (row, key) pairs
    (S(S+1)/2 per head causal, S·Sk full), 4·D each forward (QKᵀ and PV),
    10·D backward (recomputed QKᵀ, dO·Vᵀ, dV, dK, dQ), at the bf16
    tensor-core peak; one exp2 per visible pair, forward and backward alike
    (the function needs one; the tensor-core backward's dQ blocks recompute
    P and take a second, a cost of that design and not of the function), at
    the special-function units' rate at the measured SM clock.  Returns
    (ms, "bytes" or "operations", which of the three)."""
    sk = s if sk is None else sk
    qo, kv_elems, rows = b * s * h * d, b * sk * kv * d, b * h * s
    if backward:   # read q, k, v, o, dO, lse; write dq, dk, dv
        nbytes = (4 * qo + 4 * kv_elems) * esz + 4 * rows
    else:          # read q, k, v; write o, lse
        nbytes = (2 * qo + 2 * kv_elems) * esz + 4 * rows
    if mode == "full":
        pairs = b * h * s * sk
    elif mode == "causal" and sk == s:
        pairs = b * h * s * (s + 1) / 2
    else:
        raise ValueError(f"flash_bound counts causal (Sq = Sk) and full pairs, got {mode}")
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "flops": (10 if backward else 4) * d * pairs / PEAK_FLOPS[torch.bfloat16],
             "exponentials": pairs / (EX2_PER_CLOCK * sm_mhz * 1e6)}
    what = max(times, key=times.get)
    return times[what] * 1e3, ("bytes" if what == "bytes" else "operations"), what


def flash_cuda_core(q, k, v, o=None, lse=None, do=None, mode="causal"):
    """The kept CUDA-core flash kernels, whatever the inputs' type: the
    library's ``*_cuda_core`` entry points, which the port's wrappers never
    call (they let the source choose by type and head dim).  Forward with
    three tensors, backward with six; causal or full."""
    code = flash_attention.MODES[mode]
    lib = flash_attention.library()
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dtype, stream = (0 if q.dtype == torch.float32 else 1), torch.cuda.current_stream().cuda_stream
    if o is None:
        o, lse = torch.empty_like(q), torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        err = lib.flash_attention_fwd_cuda_core(
            dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, sq, sk, h, kvh, d, code, 0, 1.0 / math.sqrt(d), stream)
        outs = (o, lse)
    else:
        outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        err = lib.flash_attention_bwd_cuda_core(
            dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), *(t.data_ptr() for t in outs), b, sq, sk, h, kvh, d, code, 0,
            1.0 / math.sqrt(d), stream, None)
    if err:
        raise RuntimeError(f"CUDA-core flash launch failed: cudaError_t {err}")
    return outs


def time_flash(gen, b, s, h, kv, d, label="", sk=None, mode="causal") -> dict[str, dict]:
    """The flash pair in bf16 at (b, s, h, kv, d), S queries over ``sk``
    keys (default S), causal or full: kernel, kept CUDA-core kernels, plain
    version and SDPA (K/V heads expanded for GQA: what one library call
    needs), with the bound."""
    reg = dispatch.registry()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    causal = mode == "causal"
    q, k, v, do = flash_inputs(gen, b, s, h, kv, d, torch.bfloat16, sk)
    o, lse = reg["flash_attention"].kernel(q, k, v, mode=mode)
    # SDPA takes (B, H, S, D); its backward is timed from one retained graph
    qt, kt, vt = (t.repeat_interleave(h // t.shape[2], dim=2).transpose(1, 2).contiguous()
                  .requires_grad_() for t in (q, k, v))
    ot = sdpa(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2).contiguous()
    out = {}
    for name, backward in (("flash_attention", False), ("flash_attention_bwd", True)):
        op = reg[name]
        args = (q, k, v, o, lse, do) if backward else (q, k, v)
        lib = ((lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True))
               if backward else (lambda: sdpa(qt, kt, vt, is_causal=causal)))
        ms, mhz = cuda_ms(lambda: op.kernel(*args, mode=mode), reps=30)
        bound_ms, bound_by, bound_what = flash_bound(b, s, h, kv, d, 2, backward, mhz, sk, mode)
        out[name] = {"ms": ms, "path": flash_attention.path_for(q.dtype, d),
                     "cuda_core_ms": cuda_ms(lambda: flash_cuda_core(*args, mode=mode),
                                             reps=10)[0],
                     "plain_ms": cuda_ms(lambda: op.plain(*args, mode=mode), reps=10)[0],
                     "library_ms": cuda_ms(lib, reps=30)[0], "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_by_detail": bound_what, "sm_clock_mhz": mhz,
                     "shape": {"q": list(q.shape), "kv": list(k.shape), "mode": mode,
                               "dtype": "bfloat16"}}
        log(f"time {name}{label}: " + json.dumps(out[name]))
    del qt, kt, vt, ot
    return out


def time_train_kernels(dev) -> dict[str, dict]:
    """Kernel, plain and library times at the training path's shapes in
    bf16: attention at the paper model's (R·B 16, S 1024, H = KV = 16, D 48,
    causal) on the path the main path takes (tensor cores) and on the kept
    CUDA-core kernels (``cuda_core_ms``), the outer update on the stacked
    embedding leaf, the largest of the path (4 × 128,000 × 768)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    reg = dispatch.registry()
    out = time_flash(gen, **PAPER)
    args = [torch.randn((4, 128_000, 768), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(4)]
    coef = dict(alpha=0.5, beta=0.7, gamma=0.9186)
    op = reg["noloco_update"]
    n = args[0].numel()
    t_bytes, t_ops = 6 * n * 2 / HBM_BYTES_PER_S, 8 * n / PEAK_FLOPS[torch.float32]
    ms, mhz = cuda_ms(lambda: op.kernel(*args, **coef), reps=30)
    out["noloco_update"] = {
        "ms": ms, "plain_ms": cuda_ms(lambda: op.plain(*args, **coef), reps=10)[0],
        "library_ms": None, "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "sm_clock_mhz": mhz,
        "shape": {"leaf": [4, 128_000, 768], "dtype": "bfloat16"}}
    log("time noloco_update: " + json.dumps(out["noloco_update"]))
    return out


def split_counts(args, chunk, mode, window) -> dict:
    """The split plan of a paged call, from the library: keys per split, the
    grid's split axis, and the splits each slot runs."""
    q, _, _, tables, positions = args
    c = q.shape[1] if chunk else 1
    mb, bs = tables.shape[1], args[1].shape[1]
    plans = [paged_attention.split_plan(p, c, mb, bs, mode, window) for p in positions.tolist()]
    return {"keys_per_split": plans[0][0], "grid_splits": plans[0][1],
            "slot_splits": [n for _, _, n in plans]}


def time_kernels(dev, h=H, kv=KV, d=D) -> dict[str, dict]:
    """Kernel, plain and library times at the serve phase's shapes in bf16:
    decode over its 4 slots, one prefill chunk of 32 (the engine prefills
    one slot per call) at the last chunk of a 200-token prompt.  The kernel
    is also timed at one split per slot (``ms_one_tile``: contexts of 16, or
    the first chunk) to split its time into a fixed part and a per-split
    part; the lines carry the split plan (``split_counts``)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    heads = dict(h=h, kv=kv, d=d)
    out = {}
    for name in PAGED:
        op = dispatch.registry()[name]
        chunk = name == "paged_chunk_attention"
        pos = [168] if chunk else DECODE_POS
        args = kernel_inputs(gen, chunk=chunk, dtype=torch.bfloat16, r=len(pos), positions=pos,
                             **heads)
        short = kernel_inputs(gen, chunk=chunk, dtype=torch.bfloat16, r=len(pos),
                              positions=[0] if chunk else [15] * len(pos), **heads)
        qd, k, v, mask = sdpa_inputs(*args, chunk)
        bound_ms, bound_by = bound(args[0], args[1], args[4], chunk, kv=kv, d=d)
        ms, mhz = cuda_ms(lambda: op.kernel(*args))
        out[name] = {
            "ms": ms,
            "ms_one_tile": cuda_ms(lambda: op.kernel(*short))[0],
            "plain_ms": cuda_ms(lambda: op.plain(*args))[0],
            "library_ms": cuda_ms(lambda: sdpa(qd, k, v, attn_mask=mask))[0],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "sm_clock_mhz": mhz,
            **split_counts(args, chunk, "causal", 0),
            "shape": {"q": list(args[0].shape), "pages": list(args[1].shape),
                      "positions": pos, "dtype": "bfloat16"},
        }
        log(f"time {name}{'' if d == D else f' at D {d}'}: " + json.dumps(out[name]))
    return out


# ---------------------------------------------------------------------------
# Phase 4: serve qwen3-0.6b at full width
# ---------------------------------------------------------------------------


SERVE_MIX = dict(n=8, prompt_lens=[24, 80, 200], gen_lens=[16, 32])
SERVE_CFG = dict(max_slots=4, num_pages=NUM_PAGES, page_size=BS, max_new_cap=32,
                 prefill_chunk=32, sync_each_step=True)


def serve_phase(dev, cfg=qwen3_0_6b.CONFIG, expected=None, temps=(0.0,), solo=True):
    """Serve ``cfg`` at published width on weights from seed 0 with the
    phase-4 mix, request i at ``temps[i % len(temps)]``.
    ``expected(chunk_calls, decode_steps)`` gives the launch count of every
    kernel the model runs; without it the paged kernels must have launched.
    Requests 1 and 5 are decoded again alone unless ``solo`` is False (MoE:
    capacity is shared by the rows routed together, so a request's tokens
    may depend on its batch).  The profiled request is request 0 cut to 8
    tokens at the highest temperature."""
    label = cfg.name + (" sampled" if max(temps) > 0 else "")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    log(f"serve: {cfg.name} {cfg.num_layers}L d{cfg.d_model} {cfg.dtype} "
        f"initialised in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of weights")
    scfg = ServeConfig(**SERVE_CFG)
    requests = synth_requests(SERVE_MIX["n"], cfg.vocab_size, SERVE_MIX["prompt_lens"],
                              SERVE_MIX["gen_lens"], list(temps), seed=0)
    # warm-up (CUDA context, cuBLAS handles, the kernel library), not counted
    ServeEngine(params, cfg, scfg).run([dataclasses.replace(requests[0], max_new=2)])
    torch.cuda.synchronize()

    finished = {}
    dispatch.reset_launches()
    summary = serve_run(
        params, cfg, scfg, requests,
        log=lambda ev: finished.update({ev["rid"]: ev["tokens"]}) if ev["event"] == "finish" else None,
    )
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    summary["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"serve {label} run_end: " + json.dumps(summary))
    log(f"serve {label} launches: " + json.dumps(launches))
    for r in requests:
        if len(finished.get(r.rid, [])) != r.max_new:
            raise AssertionError(f"request {r.rid}: {len(finished.get(r.rid, []))} of {r.max_new} tokens")
    if expected is None:
        for name in PAGED:
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the serve path")
    else:
        chunk_calls = sum(-(-len(r.prompt) // scfg.prefill_chunk) for r in requests)
        want = expected(chunk_calls, summary["decode_steps"])
        log(f"serve {label} launches expected ({chunk_calls} chunk calls, "
            f"{summary['decode_steps']} decode steps): " + json.dumps(want))
        if any(launches[k] != n for k, n in want.items()):
            raise AssertionError(f"{cfg.name}: launch counts {launches} differ from the design's {want}")
    for r in (requests[1], requests[5]) if solo else ():
        [alone] = ServeEngine(params, cfg, scfg).run([dataclasses.replace(r)])
        if alone.tokens != finished[r.rid]:
            raise AssertionError(f"{label} request {r.rid}: batched tokens differ from solo")
    log(f"serve {label}: " + (f"batched == solo for requests 1 and 5 (temperatures "
                              f"{requests[1].temperature}, {requests[5].temperature})" if solo else
                              "batched == solo not held (MoE: capacity is shared by the batch)"))
    # 1 prefill chunk, 7 decode steps
    short = dataclasses.replace(requests[0], max_new=8, temperature=max(temps))
    summary["profile"] = profile_request(params, cfg, scfg, short)
    log(f"profile {label}: " + json.dumps(summary["profile"]))
    del params
    torch.cuda.empty_cache()
    return summary, launches


def sampling_phase(dev) -> dict:
    """What sampling costs at qwen3-0.6b's width, measured before any
    profiler has run in the process: the phase-4 mix served in turns greedy
    and at temperatures 0.0/0.7 (greedy, sampled, greedy, sampled) on one
    set of seed-0 weights, step p50/p99 and tokens/s of each; then the draw
    of one decode step with 4 sampled rows (``engine._perturb``: keys to the
    card, threefry bits, uniforms, Gumbel noise, the noisy rows written
    back) timed alone: device ms with the host hidden (``cuda_ms``) and wall
    ms per call, 20 calls back to back."""
    from repro_torch.serve import engine as serve_engine

    cfg = cut(qwen3_0_6b.CONFIG, QWEN3_LAYERS)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    scfg = ServeConfig(**SERVE_CFG)
    mix = (SERVE_MIX["n"], cfg.vocab_size, SERVE_MIX["prompt_lens"], SERVE_MIX["gen_lens"])
    ServeEngine(params, cfg, scfg).run([dataclasses.replace(synth_requests(*mix, [0.7], seed=0)[0],
                                                            max_new=2)])
    turns = []
    for temps in ([0.0], [0.0, 0.7], [0.0], [0.0, 0.7]):
        run = serve_run(params, cfg, scfg, synth_requests(*mix, temps, seed=0))
        turns.append({"temps": temps, **{k: run[k] for k in (
            "step_p50_s", "step_p99_s", "tokens_per_s", "ttft_p50_s", "decode_steps")}})
    log("serve qwen3-0.6b greedy and sampled in turns: " + json.dumps(turns))
    del params
    torch.cuda.empty_cache()

    logits = torch.randn(4, cfg.vocab_size, device=dev)
    draws = [(0.7, rid, 5) for rid in range(4)]

    def draw():
        return serve_engine._perturb(logits, draws)

    ms, mhz = cuda_ms(draw, reps=50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        draw()
    torch.cuda.synchronize()
    out = {"turns": turns, "draw": {"rows": 4, "vocab": cfg.vocab_size, "ms": ms,
                                    "wall_ms_per_call": (time.perf_counter() - t0) / 20 * 1e3,
                                    "sm_clock_mhz": mhz}}
    log("time sampling draw: " + json.dumps(out["draw"]))
    return out


def span_union_ms(events) -> float:
    """Milliseconds in which at least one of the profiler ``events`` ran on
    the card: the union of their spans, each overlap counted once."""
    total, end = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def profile_request(params, cfg, scfg, request) -> dict:
    """Where one request's time goes: serve it alone under torch.profiler and
    split the wall time into device busy time (every kernel and copy on the
    card) and the rest, in which the card waits for the host.  Busy times
    are unions of spans, not sums: the paged merge kernel is a programmatic
    dependent launch that starts while its split pass runs
    (``spans_overlap_ms``: the sum of the spans less their union).  The
    profiler's own cost is in the wall time."""
    from torch.profiler import ProfilerActivity, profile

    engine = ServeEngine(params, cfg, scfg)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run([dataclasses.replace(request)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = span_union_ms(on_card)
    attn_ms = span_union_ms(e for e in on_card if "paged_attention_kernel" in e.name)
    recurrent = {k: [e for e in on_card if k in e.name] for k in RECURRENT_KERNELS}
    recurrent_ms = span_union_ms(e for evs in recurrent.values() for e in evs)
    return {
        "rid": request.rid, "prompt": len(request.prompt), "max_new": request.max_new,
        "decode_steps": engine.decode_steps, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if on_card else "not measured",
        "device_idle_share": 1 - busy_ms / wall_ms if on_card else "not measured",
        "spans_overlap_ms": sum(e.time_range.elapsed_us() for e in on_card) / 1e3 - busy_ms,
        "paged_attention_ms": attn_ms, "recurrent_kernels_ms": recurrent_ms,
        # each recurrent kernel alone: the union of its spans and its launches
        "recurrent_kernels_split": {k: {"ms": span_union_ms(evs), "launches": len(evs)}
                                    for k, evs in recurrent.items() if evs},
        "device_ops": len(on_card),
    }


# ---------------------------------------------------------------------------
# Phase 5: the slice on the card against the plain path on the CPU
# ---------------------------------------------------------------------------


def greedy(params, cfg, prompt, steps, device, chunk=32, page_size=BS):
    """Chunked prefill of ``prompt`` then ``steps`` greedy decode steps on one
    slot; returns (tokens, fp32 logits of every step on the CPU)."""
    pages = -(-(len(prompt) + steps) // page_size)
    caches = M.init_paged_cache_tree(cfg, 1, pages, page_size, device)
    table = torch.arange(pages, dtype=torch.int32, device=device)[None]
    active = torch.ones(1, dtype=torch.bool, device=device)

    def i32(*v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    for cur in range(0, len(prompt), chunk):
        n = min(chunk, len(prompt) - cur)
        toks = i32(*(prompt[cur:cur + n] + [0] * (chunk - n)))[None]
        logits, _ = M.paged_prefill_chunk(
            params, cfg, toks, caches, PagedView(table, i32(cur), active), lengths=i32(n))
    rows = [logits[0, 0]]
    tokens = [int(rows[-1].argmax())]
    for i in range(steps):
        view = PagedView(table, i32(len(prompt) + i), active)
        logits, _ = M.paged_decode_step(params, cfg, i32(tokens[-1])[None], caches, view)
        rows.append(logits[0, 0])
        tokens.append(int(rows[-1].argmax()))
    return tokens, torch.stack(rows).cpu()


def slice_phase(dev):
    cfg = dataclasses.replace(qwen3_0_6b.CONFIG, dtype="float32", num_layers=QWEN3_LAYERS)
    t0 = time.perf_counter()
    cpu_params = M.init_params(torch.Generator().manual_seed(0), cfg)
    gpu_params = _tree_to(cpu_params, dev)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, size=40).tolist()
    dispatch.reset_launches()
    gpu_tokens, gpu_logits = greedy(gpu_params, cfg, prompt, 8, dev)
    launches = dispatch.launch_counts()
    if min(launches[name] for name in PAGED) <= 0:
        raise AssertionError(f"fp32 card run skipped a kernel: {launches}")
    cpu_tokens, cpu_logits = greedy(cpu_params, cfg, prompt, 8, torch.device("cpu"))
    err = (gpu_logits - cpu_logits).abs().max().item()
    log(f"slice fp32: card tokens {gpu_tokens}, cpu tokens {cpu_tokens}, "
        f"max logit diff {err:.3e} (atol {LOGIT_ATOL:g}), {time.perf_counter() - t0:.1f} s")
    if gpu_tokens != cpu_tokens:
        raise AssertionError("card and CPU greedy tokens differ")
    if not (torch.isfinite(gpu_logits).all() and err <= LOGIT_ATOL):
        raise AssertionError("card and CPU logits differ beyond tolerance")
    return err


# ---------------------------------------------------------------------------
# Phase 6: train paper-small-125m at full width
# ---------------------------------------------------------------------------

TRAIN = dict(method="noloco", replicas=4, per_replica_batch=4, seq_len=1024, steps=10,
             inner_steps=5, eval_every=0, inner_lr=3e-3, seed=0)


def expected_launches(cfg, run: dict, outer_syncs: int, codec: str = "none") -> dict[str, int]:
    """Launches the config implies: per inner step one forward per layer of
    each kernel's kind (attention, the whisper encoder's layers and every
    decoder layer's cross-attention block: flash; ssd: the SSD chunk scan;
    rglru: the RG-LRU scan), twice for the layers of full periods under
    remat (the backward pass runs the period again), and one backward per
    layer; every replica in the same launch.  Per outer sync one update per
    parameter leaf and, on the int8 wire, one quantize and one dequantize
    per float buffer of the fused (Δ, φ) payload (bf16 and fp32 here)."""
    tree = bytes_model.abstract_params(cfg)
    buffers = len(payload.make_spec((tree, tree)).buffers) if codec == "int8" else 0
    # each stack with whether its layers carry a cross-attention block
    stacks = [(cfg, cfg.is_encoder_decoder)]
    if cfg.is_encoder_decoder:
        stacks.append((M.encoder_cfg(cfg), False))
    out = {"noloco_update": outer_syncs * len(tree_leaves(tree)),
           "int8_quantize": outer_syncs * buffers, "int8_dequantize": outer_syncs * buffers}
    for fwd, bwd, kinds in (("flash_attention", "flash_attention_bwd",
                             ("global", "local", "encoder")),
                            ("ssd_chunk", "ssd_chunk_bwd", ("ssd",)),
                            ("rglru_scan", "rglru_scan_bwd", ("rglru",))):
        out[fwd] = out[bwd] = 0
        for c, cross in stacks:
            period, n_full, rem = tfm.layer_plan(c)

            def per_layer(kind):
                return (kind in kinds) + (cross and fwd == "flash_attention")

            in_periods = n_full * sum(map(per_layer, period))
            in_rem = sum(map(per_layer, period[:rem]))
            out[fwd] += run["steps"] * (in_periods * (2 if c.remat else 1) + in_rem)
            out[bwd] += run["steps"] * (in_periods + in_rem)
    return out


def train_phase(dev, cfg=paper_llama.SMALL, run=TRAIN, label="train"):
    """Train ``cfg`` at its published width through ``run_training`` with
    ``run``: launch counts against the config's, losses finite and falling,
    replicas apart after the syncs; then the outer step timed alone and one
    more inner step profiled."""
    log(f"{label}: {cfg.name} {cfg.num_layers}L d{cfg.d_model} H{cfg.num_heads} "
        f"vocab {cfg.vocab_size} {cfg.dtype} remat={cfg.remat}: " + json.dumps(run))
    jsonl = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         f"chip_smoke_{label.replace(' ', '_')}.jsonl")
    os.makedirs(os.path.dirname(jsonl), exist_ok=True)
    if os.path.exists(jsonl):
        os.remove(jsonl)
    gc.collect()
    torch.cuda.empty_cache()   # the earlier phases' cached blocks: recurrentgemma-9b needs ~69 GB
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    res = train_cli.run_training(cfg, device="cuda", log_jsonl=jsonl, **run)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = expected_launches(cfg, run, res["outer_syncs"])
    log(f"{label} launches: " + json.dumps({k: launches[k] for k in want})
        + " expected " + json.dumps(want))
    losses = res["losses"]
    log(f"{label} losses: " + json.dumps(losses))
    if res["outer_syncs"] != 2 or any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"launch counts {launches} differ from the config's {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not go down: {losses}")
    steps = [e for e in map(json.loads, open(jsonl)) if e["event"] == "step"]
    m = run["inner_steps"]
    # steps without a sync; step 1 warms up.  A step's dt also holds the
    # device tail of the previous step's outer sync (the next batch's copy
    # to the card waits for it).
    inner = sorted(e["dt_s"] * 1e3 for e in steps[1:] if e["step"] % m)
    p50 = statistics.median(inner)
    tokens = run["replicas"] * run["per_replica_batch"] * run["seq_len"]
    state = res.pop("state")
    del res["partners"]
    params = sum(t.numel() for t in tree_leaves(state.theta))
    prof = profile_steps(cfg, state, dev, run)
    del state
    # Two replicas are each other's only partner: a sync gives both the same
    # φ′, so right after the last one their std is 0 by construction; they
    # are told apart after the profiled inner steps instead.
    apart = res["final_weight_std"] if run["replicas"] > 2 else prof["weight_std_after_profile"]
    if not apart > 0:
        raise AssertionError(f"replicas identical: weight std {apart}")
    summary = {
        "inner_step_p50_ms": p50, "inner_step_p99_ms": inner[min(len(inner) - 1,
                                                                int(0.99 * len(inner)))],
        "inner_step_samples": len(inner),
        "tokens_per_s_steady": tokens / (p50 / 1e3), "tokens_per_s_run": res["tokens_per_s"],
        "wall_s": res["wall_s"], "peak_memory_gb": peak_gb, "stacked_params": params,
        "final_weight_std": res["final_weight_std"], "loss_first": losses[0],
        "loss_last": losses[-1], "comm_bytes": res["comm_bytes"],
        "blocking_bytes": res["blocking_bytes"], "losses": losses, **prof,
    }
    log(f"{label} summary: " + json.dumps(summary))
    del res
    torch.cuda.empty_cache()
    return summary, launches


def profile_steps(cfg, state, dev, run=TRAIN) -> dict:
    """On the trained state, after the launch counts were read: the outer
    step timed alone (synchronised before and after, median of 3), and one
    more inner step under torch.profiler for the device's busy share of its
    wall time and the hand-written kernels' share of the busy time (each
    kernel's ms and launches in the step)."""
    from torch.profiler import ProfilerActivity, profile

    tcfg = train_cli.method_config("noloco", inner_lr=3e-3, total_steps=10, warmup=1, inner_steps=5)
    program = adapters.GossipProgram(cfg, tcfg, replicas=run["replicas"], device=dev)
    batch = next(shard_iterator(LoaderConfig(
        vocab_size=cfg.vocab_size, seq_len=run["seq_len"],
        per_replica_batch=run["per_replica_batch"], replicas=run["replicas"]), start_step=10))
    outer_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program.trainer.outer_step(state)   # pairing from the outer step counter
        torch.cuda.synchronize()
        outer_ms.append((time.perf_counter() - t0) * 1e3)
    state, _ = program.inner_step(state, batch)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = program.inner_step(state, batch)
        float(metrics["loss"].mean())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    wstd = float(metrics_lib.replica_weight_std(state.theta))
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in on_card) / 1e3
    by_name: dict[str, float] = {}
    for e in on_card:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    flash_ms = sum(t for n, t in by_name.items() if "flash_" in n)
    # the kernels one by one (ms over the step, launches): flash's forward,
    # Di pre-pass, dK/dV and dQ blocks; the scans' forward and backward
    split: dict[str, list] = {}
    for e in on_card:
        kind = KERNEL_NAME.search(e.name)
        if kind:
            row = split.setdefault(kind.group(0), [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    flash_split = {k: v for k, v in split.items() if k.startswith("flash")}
    return {
        "recurrent_kernels_split": {k: v for k, v in split.items() if not k.startswith("flash")},
        "weight_std_after_profile": wstd,
        "outer_step_ms": statistics.median(outer_ms), "outer_step_samples_ms": outer_ms,
        "profiled_step_wall_ms": wall_ms,
        "device_busy_ms": busy_ms if on_card else "not measured",
        "device_busy_share": busy_ms / wall_ms if on_card else "not measured",
        "flash_kernels_ms": flash_ms, "flash_kernels_split": flash_split,
        "device_ops": len(on_card),
        "top_device_ops_ms": [[n[:60], t] for n, t in top],
    }


# ---------------------------------------------------------------------------
# Phase 18: the bf16 flash pair on the tensor cores against the CUDA cores
# ---------------------------------------------------------------------------

# Per-step losses of phase 6's run, tensor-core flash pair against the kept
# CUDA-core pair, relative.  The tensor-core kernels round P and dS to bf16
# before their products (each call within 2e-2 + 2e-2·|x| of the plain
# version, phase 3); the CUDA-core kernels keep them in fp32.  Step 1's loss
# is the forward's alone on the same weights, a mean over 65,536 tokens in
# which that rounding averages out: it read 1.7e-6 on the H100, and 1e-4
# holds a forward fault that moves the loss by more than 0.01%.  From step
# 2 on the weights differ by AdamW updates (lr 3e-3) on gradients from two
# backward kernels, and the gap grows with the steps (1.2e-4 at step 2,
# 2.6e-3 at step 10 on the H100): 1e-2 bounds that drift.
FLASH_PAIR_STEP1_RTOL = 1e-4
FLASH_PAIR_LOSS_RTOL = 1e-2


def flash_pair_train_phase(tc_losses: list[float]) -> dict:
    """Phase 6's bf16 run again with the flash op on the kept CUDA-core
    kernels: the library's entry points are pointed at its
    ``*_cuda_core`` ones for the run (the wrappers and their launch counts
    are unchanged), then restored.  The run is profiled, and the flash
    kernels that ran on the card must be the CUDA-core forward and backward
    alone, as many of each as the wrappers launched.  Per-step losses
    against phase 6's."""
    from torch.profiler import ProfilerActivity, profile

    cfg = paper_llama.SMALL
    lib = flash_attention.library()
    kept = lib.flash_attention_fwd, lib.flash_attention_bwd
    lib.flash_attention_fwd = lib.flash_attention_fwd_cuda_core
    lib.flash_attention_bwd = lib.flash_attention_bwd_cuda_core
    try:
        dispatch.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = train_cli.run_training(cfg, device="cuda", **TRAIN)
            torch.cuda.synchronize()
        launches = dispatch.launch_counts()
    finally:
        lib.flash_attention_fwd, lib.flash_attention_bwd = kept
    ran: dict[str, int] = {}
    for e in prof.events():
        kind = KERNEL_NAME.search(e.name)
        if kind and kind.group(0).startswith("flash") and e.device_type == torch.autograd.DeviceType.CUDA:
            ran[kind.group(0)] = ran.get(kind.group(0), 0) + 1
    del prof
    cc_losses = res["losses"]
    rel = [abs(t - c) / abs(c) for t, c in zip(tc_losses, cc_losses)]
    flash = {k: launches[k] for k in ("flash_attention", "flash_attention_bwd")}
    out = {"tensor_core_losses": tc_losses, "cuda_core_losses": cc_losses,
           "loss_rel_diff": rel, "loss_max_rel_diff": max(rel),
           "step1_rtol": FLASH_PAIR_STEP1_RTOL, "rtol": FLASH_PAIR_LOSS_RTOL,
           "cuda_core_wall_s": res["wall_s"], "launches": flash, "kernels_ran": ran}
    log("train bf16 flash pair, tensor cores vs CUDA cores: " + json.dumps(out))
    del res
    torch.cuda.empty_cache()
    want_ran = {"flash_fwd_kernel": flash["flash_attention"],
                "flash_bwd_kernel": flash["flash_attention_bwd"]}
    if ran != want_ran or not all(want_ran.values()):
        raise AssertionError(f"CUDA-core run: flash kernels on the card {ran}, expected {want_ran}")
    if len(cc_losses) != len(tc_losses) or not all(math.isfinite(x) for x in cc_losses):
        raise AssertionError(f"CUDA-core run: losses {cc_losses}")
    if rel[0] > FLASH_PAIR_STEP1_RTOL:
        raise AssertionError(f"bf16 flash pair: step 1's losses differ by {rel[0]:.3e} relative "
                             f"(rtol {FLASH_PAIR_STEP1_RTOL:g})")
    if max(rel) > FLASH_PAIR_LOSS_RTOL:
        raise AssertionError(f"bf16 flash pair: tensor-core and CUDA-core losses differ by "
                             f"{max(rel):.3e} relative (rtol {FLASH_PAIR_LOSS_RTOL:g})")
    return out


# ---------------------------------------------------------------------------
# Phase 7: training on the card against the CPU
# ---------------------------------------------------------------------------


def train_parity_phase(dev, codec: str = "none"):
    """Phase 7, and phase 10 with ``codec="int8"``: there the weight std is
    reported, not held to WSTD_RTOL (a last-bit difference of card and CPU
    can move a chunk's min or max, and so all of its codes)."""
    cfg = paper_llama.SMALL.reduced(dtype="float32", remat=False)
    run = dict(method="noloco", replicas=4, per_replica_batch=2, seq_len=64, steps=10,
               inner_steps=5, eval_every=0, inner_lr=3e-3, seed=0, codec=codec)
    kernels = TRAIN_KERNELS + (INT8 if codec == "int8" else ())
    t0 = time.perf_counter()
    dispatch.reset_launches()
    card = train_cli.run_training(cfg, device="cuda", **run)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    cpu = train_cli.run_training(cfg, device="cpu", **run)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    wstd_rel = abs(card["final_weight_std"] - cpu["final_weight_std"]) / cpu["final_weight_std"]
    same_pairs = len(card["partners"]) == 2 and all(
        np.array_equal(a, b) for a, b in zip(card["partners"], cpu["partners"]))
    out = {"loss_max_rel_diff": rel, "weight_std_rel_diff": wstd_rel,
           "partner_tables_identical": same_pairs,
           "partners": [p.tolist() for p in card["partners"]],
           "launches": {k: launches[k] for k in kernels},
           "seconds": time.perf_counter() - t0}
    log(f"train fp32 card vs cpu{'' if codec == 'none' else ' ' + codec}: " + json.dumps(out))
    if not same_pairs:
        raise AssertionError("card and CPU runs paired replicas differently")
    if min(out["launches"].values()) <= 0:
        raise AssertionError(f"fp32 card training skipped a kernel: {launches}")
    if not (rel <= LOSS_RTOL and (codec != "none" or wstd_rel <= WSTD_RTOL)):
        raise AssertionError(f"card and CPU training differ: losses {rel:.3e}, wstd {wstd_rel:.3e}")
    return out


# ---------------------------------------------------------------------------
# Phase 8: the int8 codec kernels against their plain versions, and timed
# ---------------------------------------------------------------------------


def int8_payload(gen, rows, n, chunk, dtype, exponents=(-30, 4)):
    """(rows, n) values whose chunks have magnitudes 10**e, e uniform in
    ``exponents`` (default 1e-30 to 1e4), and offsets of their own size; the
    first chunk of each row is constant."""
    dev = gen.device
    nb = -(-n // chunk)
    mag = torch.pow(10.0, torch.empty((rows, nb, 1), device=dev).uniform_(*exponents, generator=gen))
    off = torch.randn((rows, nb, 1), generator=gen, device=dev)
    x = (torch.randn((rows, nb, chunk), generator=gen, device=dev) + off) * mag
    x = x.reshape(rows, -1)[:, :n].contiguous()
    x[:, :min(chunk, n)] = 3.25
    return x.to(dtype)


def int8_near_ties(gen, rows, nb, chunk, dtype):
    """(rows, nb·chunk) chunks from 0 to hi = 10**e (e uniform in [-25, 20])
    whose other values put (x − lo)/safe within 2 ulp of a half-integer,
    where a division that is not correctly rounded would give another code."""
    dev = gen.device
    hi = torch.pow(10.0, torch.empty((rows, nb, 1), device=dev).uniform_(-25, 20, generator=gen))
    safe = hi * torch.tensor(ref.INV255, device=dev)
    x = (torch.randint(0, 255, (rows, nb, chunk), generator=gen, device=dev) + 0.5) * safe
    steps = torch.randint(-2, 3, (rows, nb, chunk), generator=gen, device=dev)
    for _ in range(2):   # move each value |steps| ulp
        x = torch.where(steps > 0, torch.nextafter(x, torch.full_like(x, math.inf)), x)
        x = torch.where(steps < 0, torch.nextafter(x, torch.zeros_like(x)), x)
        steps = steps - steps.sign()
    x = torch.minimum(x, hi)
    x[..., 0], x[..., 1] = 0.0, hi[..., 0]
    return x.reshape(rows, -1).to(dtype)


def plain_wide_chunks(x, chunk) -> int:
    """The chunks of ``x`` (R, N) that ``int8_quantize`` should put on its
    16-byte kernel: whole chunks (not a row's ragged last one) of rows that
    start 16-byte aligned, when ``chunk`` is a multiple of 32 16-byte words
    and at most 1,024 values (the kernel holds a chunk in registers)."""
    rows, n = x.shape
    esize = x.element_size()
    if chunk % (32 * (16 // esize)) or chunk > 1024:
        return 0
    return (n // chunk) * sum((x.data_ptr() + r * n * esize) % 16 == 0 for r in range(rows))


def check_int8_kernels(dev) -> dict[str, float]:
    """Both kernels bit-identical to their plain versions (q, scale, lo and
    the dequantized values in fp32 and bf16), the dequantize reading the
    codes through the wire's row stride as the codec gives them.  Cases:
    whole aligned chunks (16-byte path), ragged last chunks, rows that do
    not start 16-byte aligned (odd N in bf16, N % 4 in fp32), N < CHUNK,
    CHUNK 7, 256/128, 2048 and 3000, chunk magnitudes from 1e-30 to 1e4,
    chunks of denormal range and across its edge, quotients within 2 ulp of
    a half-integer, and the full-width payload.  Each line names how many
    chunks took the 16-byte path (the library's count, held against
    ``plain_wide_chunks``)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    reg = dispatch.registry()
    errors = {name: 0.0 for name in INT8}
    cases = [(rows, n, chunk, dtype, kind) for dtype in (torch.float32, torch.bfloat16)
             for rows, n, chunk, kind in (
                 (4, 8 * 1024 + 17, 1024, "mags"), (1, 64 * 1024, 1024, "mags"),
                 (3, 1000, 7, "mags"), (2, 9001, 3000, "mags"), (3, 4104, 1024, "mags"),
                 (5, 1000, 1024, "mags"), (2, 6144, 2048, "mags"), (3, 4100, 256, "mags"),
                 (3, 64 * 1024, 1024, "denormal"), (3, 64 * 1024, 1024, "denormal edge"),
                 (3, 64 * 1024, 1024, "near ties"), (3, 16 * 3000, 3000, "near ties"))]
    cases.append((4, PAYLOAD_BF16, 1024, torch.bfloat16, "full"))
    for rows, n, chunk, dtype, kind in cases:
        full = kind == "full"
        if full:
            x = torch.randn((rows, n), generator=gen, device=dev, dtype=dtype) * 0.02
        elif kind == "near ties":
            x = int8_near_ties(gen, rows, n // chunk, chunk, dtype)
        else:
            exponents = {"mags": (-30, 4), "denormal": (-44, -38), "denormal edge": (-39, -30)}[kind]
            x = int8_payload(gen, rows, n, chunk, dtype, exponents)
        wide = quantize.library_wide_chunks(x, chunk)
        if wide != plain_wide_chunks(x, chunk):
            raise AssertionError(f"int8_quantize: the library puts {wide} chunks on the 16-byte "
                                 f"path, the plain rule {plain_wide_chunks(x, chunk)}")
        got = reg["int8_quantize"].kernel(x, chunk)
        torch.cuda.synchronize()
        want = reg["int8_quantize"].plain(x, chunk)
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        if not all(g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
                   for g, w in zip(got, want)):
            raise AssertionError(f"int8_quantize differs from its plain version: rows {rows} "
                                 f"n {n} chunk {chunk} {dtype} {kind}: max_abs_err {err}, "
                                 f"{int((got[0] != want[0]).sum())} codes differ")
        errors["int8_quantize"] = max(errors["int8_quantize"], err)
        q, scale, lo = got
        del want
        nc = q.shape[1]
        wire = torch.cat([q.reshape(rows, -1), torch.zeros((rows, 8 * nc), dtype=torch.uint8,
                                                            device=dev)], dim=1)
        strided = wire[:, :nc * chunk].reshape(rows, nc, chunk)
        derr = 0.0
        for out_dtype in ((torch.bfloat16,) if full else (torch.float32, torch.bfloat16)):
            d_got = reg["int8_dequantize"].kernel(strided, scale, lo, n, out_dtype)
            torch.cuda.synchronize()
            d_want = reg["int8_dequantize"].plain(q, scale, lo, n, out_dtype)
            derr = max(derr, (d_got.float() - d_want.float()).abs().max().item())
            if not (d_got.dtype == out_dtype and torch.equal(d_got, d_want)):
                raise AssertionError(f"int8_dequantize differs from its plain version: rows {rows} "
                                     f"n {n} chunk {chunk} -> {out_dtype}: max_abs_err {derr}")
            del d_got, d_want
        errors["int8_dequantize"] = max(errors["int8_dequantize"], derr)
        log(f"check int8 {str(dtype)[6:]} rows {rows} n {n} chunk {chunk} {kind}: 16-byte path "
            f"{wide} of {rows * nc} chunks; quantize max_abs_err {err}, dequantize max_abs_err "
            f"{derr} (bit-identical) ok")
        del x, got, q, scale, lo, wire, strided
        torch.cuda.empty_cache()
    return errors


def time_int8_kernels(dev) -> dict[str, dict]:
    """Kernel and plain times at the full-width payload, the bf16 buffer of
    4 replicas × 366,477,312 values in chunks of 1024.  Bounds count the
    bytes the kernels move: quantize reads each bf16 value once and writes
    its code plus 8 bytes per chunk; dequantize reads each code and the 8
    bytes per chunk and writes the bf16 value.  No single PyTorch call
    computes either function (library: none).  ``scalar_ms`` is the quantize
    kernel on the same payload stored one element into its buffer, so that
    no row starts 16-byte aligned and every chunk takes the scalar path
    (``wide_chunks`` of each case say which path ran)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    reg = dispatch.registry()
    rows, n, chunk = 4, PAYLOAD_BF16, 1024
    x = torch.randn((rows, n), generator=gen, device=dev, dtype=torch.bfloat16) * 0.02
    q, scale, lo = reg["int8_quantize"].kernel(x, chunk)
    nc = q.shape[1]
    elems = rows * nc * chunk
    work = {
        # (bytes moved, fp32 operations): sub, div, rint, 2 clamps, min, max per value
        "int8_quantize": (rows * n * 2 + elems + 8 * rows * nc, 7 * elems,
                          (x, chunk)),
        # one fused multiply-add per value
        "int8_dequantize": (rows * n + 8 * rows * nc + rows * n * 2, 2 * rows * n,
                            (q, scale, lo, n, torch.bfloat16)),
    }
    out = {}
    for name, (nbytes, flops, args) in work.items():
        op = reg[name]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[torch.float32]
        ms, mhz = cuda_ms(lambda: op.kernel(*args), reps=20)
        out[name] = {"ms": ms, "plain_ms": cuda_ms(lambda: op.plain(*args), reps=3)[0],
                     "library_ms": None, "bound_ms": max(t_bytes, t_ops) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nbytes, "sm_clock_mhz": mhz,
                     "shape": {"x": [rows, n], "chunk": chunk, "dtype": "bfloat16"}}
        if name == "int8_quantize":
            buf = torch.empty(rows * n + 1, dtype=x.dtype, device=dev)
            shifted = buf[1:].view(rows, n)
            shifted.copy_(x)
            out[name]["wide_chunks"] = quantize.library_wide_chunks(x, chunk)
            out[name]["scalar_ms"] = cuda_ms(lambda: op.kernel(shifted, chunk), reps=20)[0]
            out[name]["scalar_wide_chunks"] = quantize.library_wide_chunks(shifted, chunk)
            del buf, shifted
        log(f"time {name}: " + json.dumps(out[name]))
    del x, q, scale, lo, work
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 9: full-width training over the int8 wire
# ---------------------------------------------------------------------------


def time_outer(cfg, state, dev, reps: int = 3) -> dict[str, list[float]]:
    """The outer step alone (synchronised before and after) on one state,
    with the plain and the int8 wire in turns."""
    times: dict[str, list[float]] = {"none": [], "int8": []}
    for _ in range(reps):
        for codec in times:
            tcfg = train_cli.method_config("noloco", inner_lr=3e-3, total_steps=10, warmup=1,
                                           inner_steps=5, comm=CommConfig(codec=codec))
            program = adapters.GossipProgram(cfg, tcfg, replicas=TRAIN["replicas"], device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            program.trainer.outer_step(state)   # pairing from the outer step counter
            torch.cuda.synchronize()
            times[codec].append((time.perf_counter() - t0) * 1e3)
    return times


def int8_train_phase(dev, none_summary: dict):
    cfg = paper_llama.SMALL
    log("train int8: " + json.dumps({**TRAIN, "codec": "int8"}))
    jsonl = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_train_int8.jsonl")
    os.makedirs(os.path.dirname(jsonl), exist_ok=True)
    if os.path.exists(jsonl):
        os.remove(jsonl)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    res = train_cli.run_training(cfg, device="cuda", codec="int8", log_jsonl=jsonl, **TRAIN)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = expected_launches(cfg, TRAIN, res["outer_syncs"], codec="int8")
    log("train int8 launches: " + json.dumps({k: launches[k] for k in want})
        + " expected " + json.dumps(want))
    cost = bytes_model.outer_step_cost(bytes_model.abstract_params(cfg), CommConfig(codec="int8"),
                                       world=TRAIN["replicas"])
    losses = res["losses"]
    log("train int8 losses: " + json.dumps(losses))
    if res["outer_syncs"] != 2 or any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"launch counts {launches} differ from the design's {want}")
    if res["comm_bytes"] != res["outer_syncs"] * cost.payload_bytes:
        raise AssertionError(f"comm bytes {res['comm_bytes']} != the byte model's "
                             f"{res['outer_syncs']} × {cost.payload_bytes}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"int8 training did not go down: {losses}")
    steps = [e for e in map(json.loads, open(jsonl)) if e["event"] == "step"]
    inner = sorted(e["dt_s"] * 1e3 for e in steps[1:] if e["step"] % TRAIN["inner_steps"])
    outer = time_outer(cfg, res["state"], dev)
    summary = {
        "inner_step_p50_ms": statistics.median(inner), "inner_step_samples": len(inner),
        "outer_step_ms_int8": statistics.median(outer["int8"]),
        "outer_step_ms_none": statistics.median(outer["none"]),
        "outer_step_samples_ms": outer,
        "outer_step_ms_none_phase6": none_summary["outer_step_ms"],
        "comm_bytes": res["comm_bytes"], "comm_bytes_none_phase6": none_summary["comm_bytes"],
        "payload_bytes_per_sync": cost.payload_bytes, "peak_memory_gb": peak_gb,
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_last_none_phase6": none_summary["loss_last"],
        "final_weight_std": res["final_weight_std"], "wall_s": res["wall_s"],
    }
    log("train int8 summary: " + json.dumps(summary))
    del res
    torch.cuda.empty_cache()
    return summary, launches


# ---------------------------------------------------------------------------
# Phases 11–12: checkpoint/resume and promotion on the card
# ---------------------------------------------------------------------------

CKPT_RUN = dict(method="noloco", replicas=4, per_replica_batch=2, seq_len=64, inner_steps=4,
                eval_every=0, inner_lr=3e-3, seed=0, total_steps=12, codec="int8")


def ckpt_phase(dev) -> dict:
    """6 steps saving every 3 (mid inner phase: syncs fall at 4, 8, 12),
    resumed to 12, against 12 uninterrupted steps, all on the card."""
    cfg = paper_llama.SMALL.reduced(dtype="float32", remat=False)
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    full = train_cli.run_training(cfg, device="cuda", steps=12, **CKPT_RUN)
    train_cli.run_training(cfg, device="cuda", steps=6, ckpt_dir=d, ckpt_every=3, **CKPT_RUN)
    cont = train_cli.run_training(cfg, device="cuda", steps=12, ckpt_dir=d, resume=True, **CKPT_RUN)
    torch.cuda.synchronize()
    trees = ("theta", "phi", "delta")
    pick = lambda st: (st.theta, st.outer.phi, st.outer.delta)
    same = {name: all(torch.equal(a, b) for a, b in zip(tree_leaves(x), tree_leaves(y)))
            for name, x, y in zip(trees, pick(cont["state"]), pick(full["state"]))}
    # the save and the restore of this state (4 replicas of θ, μ, ν, φ, δ)
    program = adapters.GossipProgram(cfg, train_cli.method_config(
        "noloco", inner_lr=3e-3, total_steps=12, inner_steps=4), replicas=4, device=dev)
    tdir = os.path.join(d, "timing")
    save_s, restore_s = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ckpt_lib.save(tdir, i, {"program": program.state_pytree(cont["state"])})
        save_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        program.load_state_pytree(cont["state"], ckpt_lib.restore(tdir, i)["program"])
        torch.cuda.synchronize()
        restore_s.append(time.perf_counter() - t0)
    nbytes = os.path.getsize(os.path.join(path, "arrays.msgpack"))
    out = {"start_step": cont["start_step"], "losses_identical": cont["losses"] == full["losses"][6:],
           "bit_identical": same, "losses": cont["losses"], "checkpoints": sorted(os.listdir(d)),
           "state_bytes": nbytes, "save_s": statistics.median(save_s),
           "restore_s": statistics.median(restore_s), "save_samples_s": save_s,
           "restore_samples_s": restore_s, "dir": d}
    log("ckpt resume on card: " + json.dumps(out))
    if cont["start_step"] != 6 or not out["losses_identical"] or not all(same.values()):
        raise AssertionError("the resumed run differs from the uninterrupted one on the card")
    return out


def promote_serve_phase(dev, ckpt_dir: str) -> dict:
    """``repro_torch.launch.serve --ckpt`` on the card and on the CPU."""
    args = ["--arch", "paper-small-125m", "--ckpt", ckpt_dir, "--replica", "1", "--weights",
            "phi", "--requests", "4", "--max-batch", "4", "--prompt-lens", "24,80",
            "--gen-lens", "16,12"]
    logs = {d: os.path.join(ckpt_dir, f"serve_{d}.jsonl") for d in ("cuda", "cpu")}
    dispatch.reset_launches()
    card = serve_cli.main([*args, "--device", "cuda", "--log-jsonl", logs["cuda"]])
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    cpu = serve_cli.main([*args, "--device", "cpu", "--log-jsonl", logs["cpu"]])
    tokens = {d: {e["rid"]: e["tokens"] for e in map(json.loads, open(p)) if e["event"] == "finish"}
              for d, p in logs.items()}
    out = {"promoted": card["promoted"], "tokens_identical": tokens["cuda"] == tokens["cpu"],
           "tokens": tokens["cuda"], "launches": {k: launches[k] for k in PAGED},
           "tokens_per_s": card["tokens_per_s"], "cpu_promoted": cpu["promoted"]}
    log("promote -> serve card vs cpu: " + json.dumps(out))
    if min(out["launches"].values()) <= 0:
        raise AssertionError(f"promoted serving skipped a paged kernel: {launches}")
    if len(tokens["cuda"]) != 4 or not out["tokens_identical"]:
        raise AssertionError("promoted serving: card and CPU tokens differ")
    return out


# ---------------------------------------------------------------------------
# Phases 13–15: the recurrent families
# ---------------------------------------------------------------------------


def ssd_chunk_inputs(gen, b, nc, q, h, p, n, pad=0):
    """x, dt (softplus, exactly 0 on the last ``pad`` rows of the last chunk),
    a in [−16, −1], B, C, fp32: the distributions of mamba2's layers."""
    dev = gen.device
    x = torch.randn((b, nc, q, h, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(torch.randn((b, nc, q, h), generator=gen, device=dev) - 2.0)
    if pad:
        dt[:, -1, q - pad:] = 0.0
    a = -torch.exp(torch.rand((h,), generator=gen, device=dev) * math.log(16.0))
    bm = torch.randn((b, nc, q, n), generator=gen, device=dev)
    cm = torch.randn((b, nc, q, n), generator=gen, device=dev)
    return [x, dt, a, bm, cm]


def ssd_chunk_f64(x, dt, a, b_mat, c_mat):
    """The plain version's formula in fp64 on the same fp32 inputs."""
    q = x.shape[2]
    xd, dtd, bd, cd = x.double(), dt.double(), b_mat.double(), c_mat.double()
    cums = torch.cumsum(dtd * a.double(), dim=2)
    diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    l_kern = torch.where(tri[None, None, :, :, None], torch.exp(diff), torch.zeros_like(diff))
    xdt = xd * dtd[..., None]
    y = torch.einsum("bcij,bcijh,bcjhp->bcihp", torch.einsum("bcin,bcjn->bcij", cd, bd), l_kern, xdt)
    decay = torch.exp(cums[:, :, -1:, :] - cums)
    return y, torch.einsum("bcjn,bcjh,bcjhp->bchnp", bd, decay, xdt)


def rglru_inputs(gen, *shape):
    dev = gen.device
    a = torch.sigmoid(torch.randn(shape, generator=gen, device=dev)) * 0.5 + 0.45
    return [a, torch.randn(shape, generator=gen, device=dev)]


def ssd_decode_inputs(gen, r, hp, n):
    dev = gen.device
    state = torch.randn((r, hp, n), generator=gen, device=dev)
    decay = torch.exp(-torch.rand((r, hp), generator=gen, device=dev))
    dtx = torch.randn((r, hp), generator=gen, device=dev)
    b, c = (torch.randn((r, n), generator=gen, device=dev) for _ in range(2))
    return [state, decay, dtx, b, c]


def long_context_inputs(gen, *, chunk, dtype, positions, h=16, kv=1, d=256, mb=None):
    """recurrentgemma-9b's local layers: MQA, 16 heads of 256, each slot's
    pages in a random order and contexts past the 2,048-token window; tables
    ``mb`` entries wide (default: two past the longest context)."""
    dev = gen.device
    c = C if chunk else 1
    need = [(p + c - 1) // BS + 1 for p in positions]
    pages = sum(need) + 3
    perm = torch.randperm(pages, generator=gen, device=dev).to(torch.int32)
    tables = torch.full((len(positions), mb or max(need) + 2), pages, dtype=torch.int32, device=dev)
    start = 0
    for i, n_i in enumerate(need):
        tables[i, :n_i] = perm[start:start + n_i]
        start += n_i
    qshape = (len(positions), c, h, d) if chunk else (len(positions), h, d)
    q = torch.randn(qshape, generator=gen, device=dev).to(dtype)
    kp = torch.randn((pages + 1, BS, kv, d), generator=gen, device=dev).to(dtype)
    vp = torch.randn((pages + 1, BS, kv, d), generator=gen, device=dev).to(dtype)
    return [q, kp, vp, tables, torch.tensor(positions, dtype=torch.int32, device=dev)]


def check_recurrent_kernels(dev) -> dict[str, float]:
    """The four recurrent kernels against their plain versions (the decode
    states and the RG-LRU scan bit for bit), each slot's decode row equal to
    its solo run, and the paged kernels at recurrentgemma-9b's shape."""
    gen = torch.Generator(device=dev).manual_seed(7)
    reg = dispatch.registry()
    errors = {name: 0.0 for name in (*RECURRENT, *PAGED)}
    # SSD chunk: the serve shape, Q 16 (reduced), 64 and 128 (training), ragged
    # chunks, Q 1, a ragged last 64-row tile with H 5, the training shape
    for case, pad in (((1, 1, 32, 32, 64, 128), 0), ((1, 1, 32, 32, 64, 128), 7),
                      ((2, 3, 16, 8, 64, 32), 5), ((2, 2, 64, 4, 64, 128), 0),
                      ((2, 2, 128, 4, 64, 128), 37), ((1, 3, 50, 3, 33, 17), 11),
                      ((2, 2, 1, 3, 64, 128), 0), ((1, 2, 100, 5, 64, 128), 13),
                      ((16, 8, 128, 32, 64, 128), 0)):
        args = ssd_chunk_inputs(gen, *case, pad=pad)
        got = reg["ssd_chunk"].kernel(*args)
        torch.cuda.synchronize()
        want = reg["ssd_chunk"].plain(*args)
        res = [_close(g, w, SSD_ATOL, SSD_RTOL, n) for g, w, n in zip(got, want, ("y", "states"))]
        err = max(e for e, _ in res)
        errors["ssd_chunk"] = max(errors["ssd_chunk"], err)
        if pad:   # pad rows add exact zeros, whatever their x, B and C
            noisy = [t.clone() for t in args]
            for i in (0, 3, 4):
                noisy[i][:, -1, case[2] - pad:] = 1e3 * torch.randn_like(noisy[i][:, -1, case[2] - pad:])
            y2, st2 = reg["ssd_chunk"].kernel(*noisy)
            q_ok = case[2] - pad
            if not (torch.equal(st2, got[1]) and torch.equal(y2[:, -1, :q_ok], got[0][:, -1, :q_ok])):
                raise AssertionError(f"ssd_chunk {case}: dt = 0 pad rows changed the result")
        log(f"check ssd_chunk B,NC,Q,H,P,N={case} pad {pad}: max_abs_err {err:.3e} "
            f"(atol {SSD_ATOL:g}, rtol {SSD_RTOL:g}) {'ok' if all(o for _, o in res) else 'FAIL'}")
        if not all(o for _, o in res):
            raise AssertionError("ssd_chunk disagrees with its plain version")
        if case[0] == 16:   # the training shape: both against an fp64 evaluation
            exact = ssd_chunk_f64(*args)
            far = {who: max((o.double() - e).abs().max().item() for o, e in zip(outs, exact))
                   for who, outs in (("kernel", got), ("plain", want))}
            log(f"check ssd_chunk B,NC,Q,H,P,N={case} against fp64: max_abs_err kernel "
                f"{far['kernel']:.3e}, plain {far['plain']:.3e}")
            if not far["kernel"] <= far["plain"]:
                raise AssertionError("ssd_chunk is farther from fp64 than its plain version")
            del exact
        del args, got, want
    # a (b, c) slice alone (8 heads: 16-column slabs) against the same slice
    # batched (128 heads: 64-column slabs), bit for bit
    args = ssd_chunk_inputs(gen, 4, 4, 64, 8, 64, 128, pad=9)
    y, st = reg["ssd_chunk"].kernel(*args)
    same = []
    for b, c in ((0, 0), (3, 3), (1, 2)):
        ys, sts = reg["ssd_chunk"].kernel(*(t[b:b + 1, c:c + 1].contiguous() if t.dim() > 1 else t
                                            for t in args))
        same.append(torch.equal(ys[0, 0], y[b, c]) and torch.equal(sts[0, 0], st[b, c]))
    torch.cuda.synchronize()
    log(f"check ssd_chunk (b, c) alone == batched (4, 4, 64, 8, 64, 128): bit-identical {same}")
    if not all(same):
        raise AssertionError("ssd_chunk: a (b, c) slice alone differs from the same slice batched")
    # the RG-LRU scan: S 1, 8, 24, 32 (loaded whole), 33 and up (the ring),
    # W 4095 / 4096 / 4097 and others no multiple of 32, B 1 and more
    for shape in ((1, 32, 4096), (1, 1, 4096), (1, 8, 4095), (2, 24, 4097), (3, 32, 4097),
                  (2, 33, 4096), (1, 1024, 4095), (2, 1024, 4097), (2, 37, 130), (3, 5, 33),
                  (16, 300, 1000)):
        args = rglru_inputs(gen, *shape)
        got = reg["rglru_scan"].kernel(*args)
        torch.cuda.synchronize()
        want = reg["rglru_scan"].plain(*args)
        err = (got - want).abs().max().item()
        errors["rglru_scan"] = max(errors["rglru_scan"], err)
        path = rglru_scan.library_path(shape[1])
        log(f"check rglru_scan {shape} path {path}: max_abs_err {err:.3e} "
            f"(bit-identical: {torch.equal(got, want)})")
        if path != ("whole" if shape[1] <= 32 else "ring"):
            raise AssertionError(f"rglru_scan: S {shape[1]} launches {path}, not the plain rule's "
                                 f"(whole up to 32 steps, the ring beyond)")
        if not torch.equal(got, want):
            raise AssertionError("rglru_scan differs from its sequential plain version")
    for r, w in ((4, 4096), (3, 130), (1, 7), (5, 257)):
        h, a, b = (torch.randn((r, w), generator=gen, device=dev) for _ in range(3))
        got = reg["rglru_decode"].kernel(h, a, b)
        solo = reg["rglru_decode"].kernel(h[-1:].contiguous(), a[-1:].contiguous(), b[-1:].contiguous())
        torch.cuda.synchronize()
        want = reg["rglru_decode"].plain(h, a, b)
        err = (got - want).abs().max().item()
        errors["rglru_decode"] = max(errors["rglru_decode"], err)
        log(f"check rglru_decode ({r}, {w}): max_abs_err {err:.3e} (bit-identical)")
        if not (torch.equal(got, want) and torch.equal(solo[0], got[-1])):
            raise AssertionError("rglru_decode differs from its plain version or its solo row")
    for r, hp, n in ((4, 2048, 128), (3, 70, 16), (1, 5, 33), (2, 64, 300)):
        args = ssd_decode_inputs(gen, r, hp, n)
        st, y = reg["ssd_decode"].kernel(*args)
        solo = reg["ssd_decode"].kernel(*(t[-1:].contiguous() for t in args))
        torch.cuda.synchronize()
        wst, wy = reg["ssd_decode"].plain(*args)
        # y: an N-term sum in another order, within 1e-5 of Σ|state′·c|
        tol = 1e-5 * torch.einsum("rkn,rn->rk", wst.abs(), args[4].abs())
        err = max((st - wst).abs().max().item(), (y - wy).abs().max().item())
        errors["ssd_decode"] = max(errors["ssd_decode"], err)
        ok = (torch.equal(st, wst) and bool(((y - wy).abs() <= tol).all())
              and torch.equal(solo[0][0], st[-1]) and torch.equal(solo[1][0], y[-1]))
        log(f"check ssd_decode ({r}, {hp}, {n}): state bit-identical, y max_abs_err "
            f"{(y - wy).abs().max().item():.3e} (within 1e-5·Σ|state′·c|) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("ssd_decode disagrees with its plain version or its solo row")
    for name in PAGED:
        op = reg[name]
        chunk = name == "paged_chunk_attention"
        for dtype in (torch.bfloat16, torch.float32):
            for mode, window in (("local", 2048), ("causal", 0)):
                args = long_context_inputs(gen, chunk=chunk, dtype=dtype, positions=[3000, 2100, 700])
                got = op.kernel(*args, mode=mode, window=window)
                torch.cuda.synchronize()
                want = op.plain(*args, mode=mode, window=window)
                err, ok = _close(got, want, ATOL[dtype], 0, name)
                errors[name] = max(errors[name], err)
                log(f"check {name} {str(dtype)[6:]} {mode} H16/KV1 D256 window {window} "
                    f"positions [3000, 2100, 700]: max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain version at D 256")
    return errors


# Shapes of the split checks: qwen3-0.6b (H 16, KV 8, D 128) and
# recurrentgemma-9b's local layers (H 16, KV 1, D 256).
SPLIT_SHAPES = {"qwen3": (16, 8, 128), "recurrentgemma": (16, 1, 256)}


def split_cases():
    """(mode, window, last query positions): contexts of 1, one key below, at
    and above a split boundary, 231; 2047 and 2048 keys with window 2048;
    windows whose first key falls inside a split (2100 with 2048: key 53;
    230 with 100: key 131)."""
    ks = paged_attention.split_plan(0, 1, NUM_PAGES, BS, "causal", 0)[0]
    return [("causal", 0, [0, ks - 2, ks - 1, ks, 230]),
            ("local", 2048, [2046, 2047, 2100]),
            ("local", 100, [230, ks + 40])]


def check_split_kernels(dev) -> dict[str, float]:
    """The split kernels against their plain versions at both models' shapes
    across split boundaries, with the engine's 128-entry tables; then each
    slot of a 4-slot call against the same slot alone, bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(9)
    reg = dispatch.registry()
    errors = {name: 0.0 for name in PAGED}
    for name in PAGED:
        op = reg[name]
        chunk = name == "paged_chunk_attention"
        for shape, (h, kv, d) in SPLIT_SHAPES.items():
            for dtype in (torch.bfloat16, torch.float32):
                for mode, window, last in split_cases():
                    pos = [max(0, t - (C - 1)) if chunk else t for t in last]
                    args = long_context_inputs(gen, chunk=chunk, dtype=dtype, positions=pos,
                                               h=h, kv=kv, d=d, mb=NUM_PAGES + 4)
                    got = op.kernel(*args, mode=mode, window=window)
                    torch.cuda.synchronize()
                    want = op.plain(*args, mode=mode, window=window)
                    err, ok = _close(got, want, ATOL[dtype], 0, name)
                    errors[name] = max(errors[name], err)
                    log(f"check split {name} {shape} {str(dtype)[6:]} {mode} {window} positions "
                        f"{pos}: splits {split_counts(args, chunk, mode, window)['slot_splits']}, "
                        f"max_abs_err {err:.3e} (atol {ATOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{name} disagrees with its plain version across splits")
        for shape, (h, kv, d) in SPLIT_SHAPES.items():
            for dtype in (torch.bfloat16, torch.float32):
                mode, window = ("local", 2048) if kv == 1 else ("causal", 0)
                args = long_context_inputs(gen, chunk=chunk, dtype=dtype, positions=[230, 70, 2000, 3],
                                           h=h, kv=kv, d=d, mb=NUM_PAGES + 4)
                batched = op.kernel(*args, mode=mode, window=window)
                q, kp, vp, tables, positions = args
                same = [torch.equal(op.kernel(q[i:i + 1].contiguous(), kp, vp, tables[i:i + 1].contiguous(),
                                              positions[i:i + 1].contiguous(), mode=mode,
                                              window=window)[0], batched[i]) for i in range(4)]
                torch.cuda.synchronize()
                log(f"check slot alone == batched {name} {shape} {str(dtype)[6:]} R 1 vs R 4: "
                    f"bit-identical {same}")
                if not all(same):
                    raise AssertionError(f"{name}: a slot alone differs from the same slot batched")
    return errors


def ssd_chunk_work(b, nc, q, h, p, n):
    """(bytes, fp32 operations) of the SSD chunk function: x, dt, a, B, C
    read once, y and the states written once; C Bᵀ once per chunk (ngroups
    1) and, per head, the causal y product and the state product, two
    operations per multiply-add."""
    elems = 2 * b * nc * q * h * p + b * nc * q * h + h + 2 * b * nc * q * n + b * nc * h * n * p
    pairs = q * (q + 1) // 2
    ops_ = 2 * b * nc * (pairs * n + h * (pairs * p + q * n * p))
    return 4 * elems, ops_


def _timing(op, args, nbytes, flops, shape, reps=100, plain_reps=20, library=None):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[torch.float32]
    ms, mhz = cuda_ms(lambda: op.kernel(*args), reps=reps)
    return {"ms": ms, "plain_ms": cuda_ms(lambda: op.plain(*args), reps=plain_reps)[0],
            "library_ms": None if library is None else cuda_ms(library, reps=reps)[0],
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "sm_clock_mhz": mhz, "shape": shape}


def time_recurrent_kernels(dev) -> tuple[dict[str, dict], dict[str, dict]]:
    """Kernel, plain and library times of the four kernels at the serve
    shapes (mamba2-370m: one chunk of 32, 32 heads of 64, N 128, 4 decode
    slots; recurrentgemma-9b: width 4096), and of the two scans at the
    training slice's shapes; then the paged kernels at recurrentgemma-9b's
    local layers.  Returns (serve-shape times, the other times)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    reg = dispatch.registry()
    out, extra = {}, {}
    for key, case, reps, plain_reps in (("ssd_chunk", (1, 1, 32, 32, 64, 128), 100, 20),
                                        ("ssd_chunk_train", (16, 8, 128, 32, 64, 128), 20, 3)):
        args = ssd_chunk_inputs(gen, *case)
        nbytes, flops = ssd_chunk_work(*case)
        t = _timing(reg["ssd_chunk"], args, nbytes, flops,
                    {"B,NC,Q,H,P,N": list(case), "dtype": "float32"}, reps, plain_reps)
        (out if key == "ssd_chunk" else extra)[key] = t
        log(f"time {key}: " + json.dumps(t))
        del args
    for key, shape, reps, plain_reps in (("rglru_scan", (1, 32, 4096), 100, 20),
                                         ("rglru_scan_train", (16, 1024, 4096), 20, 3)):
        args = rglru_inputs(gen, *shape)
        n = math.prod(shape)
        t = _timing(reg["rglru_scan"], args, 12 * n, 2 * n,
                    {"B,S,W": list(shape), "dtype": "float32"}, reps, plain_reps)
        t["path"] = rglru_scan.library_path(shape[1])
        (out if key == "rglru_scan" else extra)[key] = t
        log(f"time {key}: " + json.dumps(t))
        del args
    h, a, b = (torch.randn((4, 4096), generator=gen, device=dev) for _ in range(3))
    out["rglru_decode"] = _timing(reg["rglru_decode"], (h, a, b), 16 * h.numel(), 2 * h.numel(),
                                  {"R,W": [4, 4096], "dtype": "float32"},
                                  library=lambda: torch.addcmul(b, a, h))
    # the card's launch floor: an empty kernel, timed by the same method
    out["rglru_decode"]["launch_floor_ms"] = cuda_ms(lambda: torch.cuda._sleep(0))[0]
    log("time rglru_decode: " + json.dumps(out["rglru_decode"]))
    args = ssd_decode_inputs(gen, 4, 2048, 128)
    r, hp, n = args[0].shape
    out["ssd_decode"] = _timing(reg["ssd_decode"], args, 4 * (2 * r * hp * n + 3 * r * hp + 2 * r * n),
                                5 * r * hp * n, {"R,HP,N": [r, hp, n], "dtype": "float32"})
    # the state's bytes moved by one PyTorch copy: what reading and writing
    # them costs on this card, beside the bound (not the same function)
    copy_out = torch.empty_like(args[0])
    out["ssd_decode"]["copy_ms"] = cuda_ms(lambda: copy_out.copy_(args[0]))[0]
    log("time ssd_decode: " + json.dumps(out["ssd_decode"]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name in PAGED:
        op = reg[name]
        chunk = name == "paged_chunk_attention"
        pos = [168] if chunk else DECODE_POS
        args = long_context_inputs(gen, chunk=chunk, dtype=torch.bfloat16, positions=pos,
                                   mb=NUM_PAGES)
        short = long_context_inputs(gen, chunk=chunk, dtype=torch.bfloat16, mb=NUM_PAGES,
                                    positions=[0] if chunk else [15] * len(pos))
        q, kp, _, tables, positions = args
        c = q.shape[1] if chunk else 1
        t = int(positions.max()) + c
        blocks = -(-t // BS)
        k = kp[tables[:, :blocks].long()].reshape(len(pos), blocks * BS, 1, 256)[:, :t]
        kd = k.expand(-1, -1, 16, -1).transpose(1, 2).contiguous()
        qd = (q if chunk else q[:, None]).transpose(1, 2).contiguous()
        q_pos = positions[:, None].long() + torch.arange(c, device=dev)[None]
        kpos = torch.arange(t, device=dev)[None, None]
        mask = ((kpos <= q_pos[:, :, None]) & (kpos > q_pos[:, :, None] - 2048))[:, None]
        bound_ms, bound_by = bound(q, kp, positions, chunk, kv=1, d=256)
        ms, mhz = cuda_ms(lambda: op.kernel(*args, mode="local", window=2048))
        extra[f"{name}_recurrentgemma"] = {
            "ms": ms, "ms_one_tile": cuda_ms(lambda: op.kernel(*short, mode="local", window=2048))[0],
            "plain_ms": cuda_ms(lambda: op.plain(*args, mode="local", window=2048))[0],
            "library_ms": cuda_ms(lambda: sdpa(qd, kd, kd, attn_mask=mask))[0],
            "bound_ms": bound_ms, "bound_by": bound_by, "sm_clock_mhz": mhz,
            **split_counts(args, chunk, "local", 2048),
            "shape": {"q": list(q.shape), "pages": list(kp.shape), "positions": pos,
                      "window": 2048, "dtype": "bfloat16"}}
        log(f"time {name} at recurrentgemma-9b's shape: " + json.dumps(extra[f"{name}_recurrentgemma"]))
    torch.cuda.empty_cache()
    return out, extra


def mamba2_launches(cfg):
    n = cfg.num_layers
    return lambda chunks, steps: {"ssd_chunk": chunks * n, "ssd_decode": steps * n,
                                  "rglru_scan": 0, "rglru_decode": 0,
                                  "paged_attention": 0, "paged_chunk_attention": 0}


def recurrentgemma_launches(cfg):
    kinds = cfg.layer_types
    n_lru, n_attn = kinds.count("rglru"), kinds.count("local")
    return lambda chunks, steps: {"rglru_scan": chunks * n_lru, "rglru_decode": steps * n_lru,
                                  "paged_chunk_attention": chunks * n_attn,
                                  "paged_attention": steps * n_attn,
                                  "ssd_chunk": 0, "ssd_decode": 0}


def recurrent_parity_phase(dev) -> dict:
    """Both families' reduced() configs in fp32: a prompt of 80 and one of
    200 tokens (past the window of 64), 8 greedy decode steps each, on the
    card and on the CPU from the same weights."""
    out = {}
    for base, kernels in ((mamba2_370m.CONFIG, ("ssd_chunk", "ssd_decode")),
                          (recurrentgemma_9b.CONFIG, ("rglru_scan", "rglru_decode") + PAGED)):
        cfg = base.reduced(dtype="float32", remat=False)
        cpu_params = M.init_params(torch.Generator().manual_seed(0), cfg)
        gpu_params = _tree_to(cpu_params, dev)
        rng = np.random.default_rng(4)
        rows = []
        for length in (80, 200):
            prompt = rng.integers(0, cfg.vocab_size, size=length).tolist()
            dispatch.reset_launches()
            gpu_tokens, gpu_logits = greedy(gpu_params, cfg, prompt, 8, dev)
            launches = dispatch.launch_counts()
            cpu_tokens, cpu_logits = greedy(cpu_params, cfg, prompt, 8, torch.device("cpu"))
            err = (gpu_logits - cpu_logits).abs().max().item()
            rows.append({"prompt": length, "tokens_identical": gpu_tokens == cpu_tokens,
                         "max_logit_diff": err,
                         "launches": {k: launches[k] for k in kernels}})
            log(f"recurrent fp32 card vs cpu {cfg.name} reduced, prompt {length}: card {gpu_tokens}, "
                f"cpu {cpu_tokens}, max logit diff {err:.3e} (atol {LOGIT_ATOL:g}), "
                f"launches {rows[-1]['launches']}")
            if min(rows[-1]["launches"].values()) <= 0:
                raise AssertionError(f"fp32 card run of {cfg.name} skipped a kernel: {launches}")
            if gpu_tokens != cpu_tokens:
                raise AssertionError(f"{cfg.name}: card and CPU greedy tokens differ")
            if not (torch.isfinite(gpu_logits).all() and err <= LOGIT_ATOL):
                raise AssertionError(f"{cfg.name}: card and CPU logits differ beyond tolerance")
        out[base.name] = rows
    return out


# ---------------------------------------------------------------------------
# Phases 19–21: training the recurrent families
# ---------------------------------------------------------------------------


def ssd_chunk_bwd_work(b, nc, q, h, p, n, a_rows):
    """(bytes, fp32 operations) of the SSD chunk backward: x, dt, a, B, C,
    dy and dstates read once, dx, ddt, da, dB and dC written once; per
    chunk C Bᵀ and the two products of Σ_h dS (dC, dB), per head dM and du
    over the causal pairs and the two state products (B·dst, (dec∘u)·dstᵀ),
    two operations per multiply-add."""
    xs, dts, bcs = b * nc * q * h * p, b * nc * q * h, b * nc * q * n
    a_elems = (b if a_rows else 1) * h
    elems = 3 * xs + 2 * dts + 2 * a_elems + 4 * bcs + b * nc * h * n * p
    pairs = q * (q + 1) // 2
    ops_ = 2 * b * nc * (3 * pairs * n + h * (2 * pairs * p + 2 * q * n * p))
    return 4 * elems, ops_


def ssd_bwd_inputs(gen, b, nc, q, h, p, n, pad=0, a_rows=True):
    """ssd_chunk_inputs plus the output gradients; ``a`` per row (B, H), as
    training folds the replicas into B, unless ``a_rows`` is False.  A ragged
    sequence (``pad`` rows past its end in the last chunk) has x, B, C and
    dt zero there, as ops.ssd_chunk pads it, and dy zero (y is cut to S)."""
    args = ssd_chunk_inputs(gen, b, nc, q, h, p, n, pad=pad)
    if a_rows:
        args[2] = -torch.exp(torch.rand((b, h), generator=gen, device=gen.device) * math.log(16.0))
    dy = torch.randn((b, nc, q, h, p), generator=gen, device=gen.device)
    dst = torch.randn((b, nc, h, n, p), generator=gen, device=gen.device)
    if pad:
        for t in (args[0], args[3], args[4], dy):
            t[:, -1, q - pad:] = 0.0
    return args + [dy, dst]


def ssd_bwd_f64(x, dt, a, b_mat, c_mat, dy, dst):
    """The plain backward's vjp in fp64 on the same fp32 inputs."""
    ins = [t.double().requires_grad_() for t in (x, dt, a, b_mat, c_mat)]
    with torch.enable_grad():
        q = x.shape[2]
        cums = torch.cumsum(ins[1] * (ins[2][None, None, None] if a.dim() == 1 else ins[2][:, None, None]),
                            dim=2)
        diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]
        tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
        l_kern = torch.exp(torch.where(tri, diff, torch.full_like(diff, -math.inf)))
        xdt = ins[0] * ins[1][..., None]
        y = torch.einsum("bcij,bcijh,bcjhp->bcihp", torch.einsum("bcin,bcjn->bcij", ins[4], ins[3]),
                         l_kern, xdt)
        st = torch.einsum("bcjn,bcjh,bcjhp->bchnp", ins[3], torch.exp(cums[:, :, -1:] - cums), xdt)
        return torch.autograd.grad((y, st), ins, (dy.double(), dst.double()))


def normwise(got, want) -> float:
    """max |got − want| over max |want|."""
    return ((got.double() - want.double()).abs().max() / want.double().abs().max().clamp_min(1e-30)).item()


def check_recurrent_bwd_kernels(dev) -> dict[str, float]:
    """The scans' backward kernels against their plain versions: the RG-LRU
    one bit for bit, the SSD one normwise within SSD_BWD_RTOL (at the
    training shape also against fp64), each twice on the same inputs with
    equal bits; then the flash pair at recurrentgemma-9b's training shape."""
    gen = torch.Generator(device=dev).manual_seed(11)
    reg = dispatch.registry()
    errors = {name: 0.0 for name in (*RECURRENT_BWD, "flash_attention", "flash_attention_bwd")}
    # recurrentgemma-9b's (R·B 2, S 1024, W 4096), the training shape, a
    # ragged tail of steps and widths, S 1
    for shape in ((2, 1024, 4096), (16, 1024, 4096), (3, 37, 130), (1, 1, 4097), (2, 33, 4095),
                  (2, 17, 40), (2, 1001, 256)):
        a, b = rglru_inputs(gen, *shape)
        g = torch.randn(shape, generator=gen, device=dev)
        h = reg["rglru_scan"].kernel(a, b)
        got = reg["rglru_scan_bwd"].kernel(a, h, g)
        again = reg["rglru_scan_bwd"].kernel(a, h, g)
        torch.cuda.synchronize()
        want = reg["rglru_scan_bwd"].plain(a, b, g)
        err = max((x - y).abs().max().item() for x, y in zip(got, want))
        errors["rglru_scan_bwd"] = max(errors["rglru_scan_bwd"], err)
        same = all(torch.equal(x, y) for x, y in zip(got, want))
        repeat = all(torch.equal(x, y) for x, y in zip(got, again))
        log(f"check rglru_scan_bwd {shape}: max_abs_err {err:.3e} (bit-identical: {same}; "
            f"two calls bit-identical: {repeat})")
        if not (same and repeat):
            raise AssertionError("rglru_scan_bwd differs from its plain version or between calls")
        del a, b, g, h, got, again, want
    # the training shape (a per row), a ragged sequence (S = 2·128 + 91),
    # mamba2-370m.reduced's (R·B 8, S 64, Q 16, H 8, P 64, N 32), a (H,),
    # Q 100 / 50 with P 33 and N 17, Q 1; Q 256 with P 128 (four row tiles,
    # two steps each of N and P), H 1 with Q 130, P 30, N 66 (a ragged last
    # tile, 4-byte copies; a per row)
    cases = [((16, 8, 128, 32, 64, 128), 0, True), ((2, 3, 128, 32, 64, 128), 37, True),
             ((8, 4, 16, 8, 64, 32), 0, True), ((2, 2, 64, 4, 64, 128), 0, False),
             ((1, 2, 100, 3, 33, 17), 13, True), ((2, 1, 50, 5, 64, 128), 0, False),
             ((2, 2, 1, 3, 16, 8), 0, True), ((1, 2, 256, 4, 128, 128), 0, True),
             ((4, 2, 130, 1, 30, 66), 5, True)]
    for case, pad, a_rows in cases:
        args = ssd_bwd_inputs(gen, *case, pad=pad, a_rows=a_rows)
        got = reg["ssd_chunk_bwd"].kernel(*args)
        again = reg["ssd_chunk_bwd"].kernel(*args)
        torch.cuda.synchronize()
        want = reg["ssd_chunk_bwd"].plain(*args)
        names = ("dx", "ddt", "da", "db", "dc")
        rel = {n: normwise(g, w) for n, g, w in zip(names, got, want)}
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        errors["ssd_chunk_bwd"] = max(errors["ssd_chunk_bwd"], err)
        repeat = all(torch.equal(x, y) for x, y in zip(got, again))
        shapes_ok = all(g.shape == t.shape and g.dtype == torch.float32 for g, t in zip(got, args))
        ok = shapes_ok and repeat and max(rel.values()) <= SSD_BWD_RTOL
        log(f"check ssd_chunk_bwd B,NC,Q,H,P,N={case} pad {pad} a {'(B, H)' if a_rows else '(H,)'}: "
            f"plan {json.dumps(ssd_scan.library_bwd_plan(*case, a_rows))}, "
            f"normwise " + ", ".join(f"{n} {v:.2e}" for n, v in rel.items())
            + f" (rtol {SSD_BWD_RTOL:g}), max_abs_err {err:.3e}, two calls bit-identical {repeat} "
            + ("ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError("ssd_chunk_bwd disagrees with its plain version or between calls")
        if case[0] == 16:   # the training shape: both against fp64
            exact = ssd_bwd_f64(*args)
            far = {who: {n: normwise(o, e) for n, o, e in zip(names, outs, exact)}
                   for who, outs in (("kernel", got), ("plain", want))}
            log(f"check ssd_chunk_bwd B,NC,Q,H,P,N={case} against fp64 (normwise): "
                + json.dumps(far))
            if max(far["kernel"].values()) > SSD_BWD_RTOL:
                raise AssertionError("ssd_chunk_bwd is farther from fp64 than SSD_BWD_RTOL")
            del exact
        del args, got, again, want
    # recurrentgemma-9b's local layers in training: R·B 2, S 1024, 16 heads
    # of 256, one kv head, window 2048, bf16
    q, k, v, do = flash_inputs(gen, 2, 1024, 16, 1, 256, torch.bfloat16)
    o, lse = reg["flash_attention"].kernel(q, k, v, mode="local", window=2048)
    grads = reg["flash_attention_bwd"].kernel(q, k, v, o, lse, do, mode="local", window=2048)
    torch.cuda.synchronize()
    o_want, lse_want = reg["flash_attention"].plain(q, k, v, mode="local", window=2048)
    g_want = reg["flash_attention_bwd"].plain(q, k, v, o, lse, do, mode="local", window=2048)
    results = [("flash_attention", *_close(o, o_want, ATOL[torch.bfloat16], 0, "o")),
               ("flash_attention", *_close(lse, lse_want, 1e-4, 1e-5, "lse"))]
    results += [("flash_attention_bwd", *_close(g, w, ATOL[torch.bfloat16], GRAD_RTOL[torch.bfloat16], n))
                for g, w, n in zip(grads, g_want, ("dq", "dk", "dv"))]
    log("check flash bf16 B2 S1024 H16/KV1 D256 local 2048 (recurrentgemma-9b training) path "
        f"{flash_attention.path_for(torch.bfloat16, 256)}: "
        + ", ".join(f"{n} {e:.3e}" for n, e, _ in results))
    for name, err, ok in results:
        errors[name] = max(errors[name], err)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at recurrentgemma-9b's "
                                 f"training shape: {err:.3e}")
    return errors


def time_recurrent_bwd_kernels(dev) -> tuple[dict[str, dict], dict[str, dict]]:
    """Kernel and plain times of the two backward kernels at the training
    phases' shapes: ssd_chunk_bwd at mamba2-370m's (R·B 16, S 1024: NC 8,
    Q 128, H 32, P 64, N 128, a per row), rglru_scan_bwd at
    recurrentgemma-9b's (2, 1024, 4096) and at (16, 1024, 4096).  No single
    PyTorch call computes either: library_ms is null.  ``was``: the first
    designs' times at the same shapes (FIRST_BWD_MS)."""
    gen = torch.Generator(device=dev).manual_seed(12)
    reg = dispatch.registry()
    case = (16, 8, 128, 32, 64, 128)
    args = ssd_bwd_inputs(gen, *case)
    nbytes, flops = ssd_chunk_bwd_work(*case, a_rows=True)
    out = {"ssd_chunk_bwd": _timing(reg["ssd_chunk_bwd"], args, nbytes, flops,
                                    {"B,NC,Q,H,P,N": list(case), "a": "(B, H)", "dtype": "float32"},
                                    reps=20, plain_reps=3)}
    out["ssd_chunk_bwd"]["plan"] = ssd_scan.library_bwd_plan(*case, True)
    out["ssd_chunk_bwd"]["was"] = {"ms": FIRST_BWD_MS["ssd_chunk_bwd"], "of": "CUDA-core design"}
    log("time ssd_chunk_bwd: " + json.dumps(out["ssd_chunk_bwd"]))
    del args
    extra = {}
    for key, shape in (("rglru_scan_bwd", (2, 1024, 4096)), ("rglru_scan_bwd_16", (16, 1024, 4096))):
        a, b = rglru_inputs(gen, *shape)
        g = torch.randn(shape, generator=gen, device=dev)
        h = reg["rglru_scan"].kernel(a, b)
        n = math.prod(shape)
        t_bytes, t_ops = 20 * n / HBM_BYTES_PER_S, 3 * n / PEAK_FLOPS[torch.float32]
        ms, mhz = cuda_ms(lambda: reg["rglru_scan_bwd"].kernel(a, h, g), reps=50)
        t = {"ms": ms, "plain_ms": cuda_ms(lambda: reg["rglru_scan_bwd"].plain(a, b, g), reps=3)[0],
             "library_ms": None, "bound_ms": max(t_bytes, t_ops) * 1e3,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": 20 * n,
             "flops": 3 * n, "sm_clock_mhz": mhz, "shape": {"B,S,W": list(shape), "dtype": "float32"},
             "ring": rglru_scan.library_bwd_ring(),
             "was": {"ms": FIRST_BWD_MS[key], "of": "register-ring design"}}
        (out if key == "rglru_scan_bwd" else extra)[key] = t
        log(f"time {key}: " + json.dumps(t))
        del a, b, g, h
    torch.cuda.empty_cache()
    return out, extra


# The two families at published width in bf16 with remat, NoLoCo, m 5, 10
# steps, 2 syncs.  mamba2-370m at full depth with phase 6's run.
# recurrentgemma-9b at the depth that holds its three kinds (rglru, rglru,
# local) with 2 replicas × batch 1 × seq 1024: its tied embedding alone is
# 1.05 B parameters (PERF.md holds the memory reckoning).
RECURRENT_TRAIN = (
    (dataclasses.replace(mamba2_370m.CONFIG, num_layers=MAMBA2_TRAIN_LAYERS), TRAIN),
    (dataclasses.replace(recurrentgemma_9b.CONFIG, num_layers=3),
     dict(TRAIN, replicas=2, per_replica_batch=1)),
)


def recurrent_train_parity_phase(dev) -> dict:
    """Phase 7 for both families: ``reduced()`` in fp32 (recurrentgemma-9b
    at 3 layers: rglru, local, rglru), NoLoCo on the card and on the CPU from
    the same initial state: identical partner tables, per-step losses within
    LOSS_RTOL, final weight std within WSTD_RTOL.  The card run is profiled:
    every CUDA kernel of the scans' wrappers ran as many times as the
    wrapper counted its launches, both backward kernels included."""
    from torch.profiler import ProfilerActivity, profile

    run = dict(method="noloco", replicas=4, per_replica_batch=2, seq_len=64, steps=10,
               inner_steps=5, eval_every=0, inner_lr=3e-3, seed=0)
    out = {}
    for base, kw, own in ((mamba2_370m.CONFIG, {}, {"ssd_chunk": ("ssd_chunk_kernel",),
                                                     "ssd_chunk_bwd": (
                                                         "ssd_bwd_cums_kernel", "ssd_bwd_pairs_mma_kernel",
                                                         "ssd_bwd_keys_mma_kernel", "ssd_bwd_bc_mma_kernel",
                                                         "ssd_bwd_dt_kernel")}),
                          (recurrentgemma_9b.CONFIG, {"num_layers": 3},
                           {"rglru_scan": ("rglru_scan_kernel",),
                            "rglru_scan_bwd": ("rglru_scan_bwd_ring_kernel",)})):
        cfg = base.reduced(dtype="float32", remat=False, **kw)
        t0 = time.perf_counter()
        dispatch.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            card = train_cli.run_training(cfg, device="cuda", **run)
            torch.cuda.synchronize()
        launches = dispatch.launch_counts()
        ran: dict[str, int] = {}
        for e in prof.events():
            kind = KERNEL_NAME.search(e.name)
            if kind and e.device_type == torch.autograd.DeviceType.CUDA:
                ran[kind.group(0)] = ran.get(kind.group(0), 0) + 1
        del prof
        cpu = train_cli.run_training(cfg, device="cpu", **run)
        rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
        wstd_rel = abs(card["final_weight_std"] - cpu["final_weight_std"]) / cpu["final_weight_std"]
        same_pairs = len(card["partners"]) == 2 and all(
            np.array_equal(a, b) for a, b in zip(card["partners"], cpu["partners"]))
        row = {"loss_max_rel_diff": rel, "weight_std_rel_diff": wstd_rel,
               "partner_tables_identical": same_pairs, "launches": {k: launches[k] for k in own},
               "kernels_ran": ran, "card_losses": card["losses"], "cpu_losses": cpu["losses"],
               "seconds": time.perf_counter() - t0}
        log(f"train recurrent fp32 card vs cpu {cfg.name} reduced {cfg.num_layers}L: " + json.dumps(row))
        if not same_pairs:
            raise AssertionError(f"{cfg.name}: card and CPU runs paired replicas differently")
        for wrapper, names in own.items():
            if launches[wrapper] <= 0 or any(ran.get(n, 0) != launches[wrapper] for n in names):
                raise AssertionError(f"{cfg.name}: {wrapper} counted {launches[wrapper]} launches, "
                                     f"the card ran {ran}")
        if not (rel <= LOSS_RTOL and wstd_rel <= WSTD_RTOL):
            raise AssertionError(f"{cfg.name}: card and CPU training differ: losses {rel:.3e}, "
                                 f"wstd {wstd_rel:.3e}")
        out[cfg.name] = row
        del card, cpu
    return out


# ---------------------------------------------------------------------------
# Phases 22–25: the MoE family
# ---------------------------------------------------------------------------

GRANITE = granite_moe_1b.CONFIG
# granite-moe-1b-a400m's heads (16 of 64, KV 8) and its training shape, 2
# replicas × batch 4 folded into B
GRANITE_HEADS = dict(h=16, kv=8, d=64)
GRANITE_TRAIN_SHAPE = dict(b=8, s=1024, **GRANITE_HEADS)
GRANITE_TRAIN = dict(TRAIN, replicas=2, per_replica_batch=4)
# A routing decision that differs between card and CPU must be a near tie:
# its top-k margin (the k-th probability less the next) under NEAR_TIE.
NEAR_TIE = 1e-5
# One loss-and-gradient evaluation, card against CPU (fp32): the loss
# within LOSS_RTOL; each gradient leaf within GRAD_NORM_RTOL of that leaf's
# largest magnitude (sums of up to B·S terms in another order).
GRAD_NORM_RTOL = 1e-4
OTHER_ARCHS = ("gemma-2b", "stablelm-1.6b", "minitron-8b", "qwen3-moe-235b-a22b")


def check_granite_kernels(dev) -> dict[str, float]:
    """Phase 22: the flash pair at granite's training shape (B 8, S 1024,
    H 16, KV 8, D 64, causal), ragged and local, bf16 (tensor cores) and
    fp32 (CUDA cores); the paged pair at its heads, causal and local, bf16
    and fp32; each against its plain version."""
    gen = torch.Generator(device=dev).manual_seed(22)
    errors: dict[str, float] = {}
    for dtype in (torch.bfloat16, torch.float32):
        for b, s, mode, window in ((8, 1024, "causal", 0), (2, 333, "causal", 0),
                                   (2, 300, "local", WINDOW)):
            check_flash_case(gen, dtype, b, s, 16, 8, 64, mode, window, errors, label=" granite")
    for name in PAGED:
        errors[name] = max(
            check_paged_case(gen, name, dtype, mode, window, 16, 8, d=64, label=" granite")
            for dtype in (torch.bfloat16, torch.float32)
            for mode, window in (("causal", 0), ("local", WINDOW)))
    return errors


def time_granite_kernels(dev) -> dict[str, dict]:
    """The flash pair at granite's training shape and the paged pair at its
    heads (the serve phase's slots and chunk), bf16, with SDPA and the bound."""
    gen = torch.Generator(device=dev).manual_seed(23)
    flash = time_flash(gen, **GRANITE_TRAIN_SHAPE, label=" at granite's training shape")
    paged = time_kernels(dev, **GRANITE_HEADS)
    return {f"{k}_granite": v for k, v in {**flash, **paged}.items()}


def time_moe_block(dev) -> dict:
    """One granite MoE layer at its training shape (2 replicas × 4 × 1024
    tokens, bf16), forward and backward, device ms: the whole block, and
    its expert products alone (the three batched products and the
    activation on a full (E, cap, d) buffer).  The difference is routing,
    ranks, dispatch and combine: eager PyTorch."""
    cfg = GRANITE
    gen = torch.Generator(device=dev).manual_seed(24)
    p = {k: v[None].expand(2, *v.shape).contiguous().requires_grad_()
         for k, v in moe.init_moe(gen, cfg).items()}
    x = torch.randn((2, 4, 1024, cfg.d_model), generator=gen, device=dev).bfloat16()
    x.requires_grad_()
    dy = torch.randn_like(x)
    cap = moe.capacity(4 * 1024, cfg.num_experts_per_token, cfg.num_experts,
                       cfg.moe_capacity_factor)
    buf = torch.randn((2, cfg.num_experts, cap, cfg.d_model), generator=gen,
                      device=dev).bfloat16().requires_grad_()
    dbuf = torch.randn_like(buf)
    leaves = [x, buf, *p.values()]

    def block():
        for t in leaves:
            t.grad = None
        y, aux = moe.apply_moe(p, cfg, x)
        torch.autograd.backward([y, aux], [dy, torch.ones_like(aux)])

    def products():
        for t in leaves:
            t.grad = None
        h = torch.matmul(buf, p["w_in"])
        out = torch.matmul(torch.nn.functional.silu(torch.matmul(buf, p["w_gate"])) * h, p["w_out"])
        out.backward(dbuf)

    out = {"block_ms": cuda_ms(block, reps=10)[0], "products_ms": cuda_ms(products, reps=10)[0],
           "tokens": 2 * 4 * 1024, "capacity": cap}
    out["routing_dispatch_combine_ms"] = out["block_ms"] - out["products_ms"]
    log("time moe block granite (fwd + bwd): " + json.dumps(out))
    del p, x, buf
    torch.cuda.empty_cache()
    return out


def granite_launches(cfg):
    n = cfg.num_layers
    return lambda chunks, steps: {"paged_chunk_attention": chunks * n,
                                  "paged_attention": steps * n, "ssd_chunk": 0,
                                  "ssd_decode": 0, "rglru_scan": 0, "rglru_decode": 0}


class RoutingLog:
    """While entered, records every MoE routing call of the port: its top-k
    expert ids and each token's top-k margin, on the host."""

    def __enter__(self):
        self.calls, self._real = [], moe.route
        moe.route = self._spy
        return self

    def __exit__(self, *exc):
        moe.route = self._real

    def _spy(self, router, xt, k):
        probs, top_p, top_e = self._real(router, xt, k)
        srt = probs.detach().sort(dim=-1, descending=True).values
        self.calls.append((top_e.cpu(), (srt[..., k - 1] - srt[..., k]).cpu()))
        return probs, top_p, top_e


def routing_diff(card: RoutingLog, cpu: RoutingLog) -> dict:
    """Routing decisions that differ between two runs' calls, call for
    call: the count of tokens whose top-k differs, the first call with one,
    and the flipped tokens' margins on the CPU."""
    if len(card.calls) != len(cpu.calls):
        return {"calls": [len(card.calls), len(cpu.calls)], "differ": None}
    count, first, margins = 0, None, []
    for i, ((ce, _), (pe, pm)) in enumerate(zip(card.calls, cpu.calls)):
        differ = (ce != pe).any(dim=-1)
        n = int(differ.sum())
        if n and first is None:
            first = i
        count += n
        margins += pm[differ].tolist()
    return {"calls": len(cpu.calls), "differ": count, "first_call": first,
            "margins": margins}


def near_ties_only(diff: dict, what: str) -> None:
    if diff["differ"] is None:
        raise AssertionError(f"{what}: card and CPU made {diff['calls']} routing calls")
    if diff["differ"] and max(diff["margins"]) >= NEAR_TIE:
        raise AssertionError(f"{what}: routing decisions differ off a near tie: {diff}")


def moe_serve_parity(dev) -> dict:
    """granite-moe-1b-a400m.reduced() in fp32, the phase-4 mix through the
    engine on the card and on the CPU from the same weights: identical
    tokens, the routing decisions that differ counted (0 expected; any
    must be a near tie, and the tokens are then held up to it)."""
    cfg = GRANITE.reduced(dtype="float32", remat=False)
    cpu_params = M.init_params(torch.Generator().manual_seed(0), cfg)
    gpu_params = _tree_to(cpu_params, dev)
    scfg = ServeConfig(**SERVE_CFG)
    requests = synth_requests(SERVE_MIX["n"], cfg.vocab_size, SERVE_MIX["prompt_lens"],
                              SERVE_MIX["gen_lens"], [0.0], seed=0)
    t0 = time.perf_counter()
    dispatch.reset_launches()
    with RoutingLog() as card_log:
        card = {f.rid: f.tokens for f in ServeEngine(gpu_params, cfg, scfg).run(
            [dataclasses.replace(r) for r in requests])}
    torch.cuda.synchronize()
    launches = {k: dispatch.launch_counts()[k] for k in PAGED}
    with RoutingLog() as cpu_log:
        cpu = {f.rid: f.tokens for f in ServeEngine(cpu_params, cfg, scfg).run(
            [dataclasses.replace(r) for r in requests])}
    diff = routing_diff(card_log, cpu_log)
    row = {"tokens_identical": card == cpu, "routing": diff, "launches": launches,
           "requests": len(requests), "seconds": time.perf_counter() - t0}
    log("serve granite-moe-1b-a400m fp32 card vs cpu reduced: " + json.dumps(row))
    if min(launches.values()) <= 0:
        raise AssertionError(f"fp32 card serving skipped a paged kernel: {launches}")
    near_ties_only(diff, "granite serving")
    if diff["differ"] == 0 and card != cpu:
        raise AssertionError("granite serving: card and CPU tokens differ")
    return row


def moe_train_parity(dev) -> dict:
    """Phase 7 for granite-moe-1b-a400m.reduced() in fp32 (NoLoCo, 4
    replicas, 2 outer rounds), with every routing call of both runs
    recorded: identical partner tables, the routing decisions that differ
    counted (0 expected), per-step losses within LOSS_RTOL before the first
    step with one and the final weight std within WSTD_RTOL if there is
    none; a differing decision must be a near tie."""
    cfg = GRANITE.reduced(dtype="float32", remat=False)
    run = dict(method="noloco", replicas=4, per_replica_batch=2, seq_len=64, steps=10,
               inner_steps=5, eval_every=0, inner_lr=3e-3, seed=0)
    t0 = time.perf_counter()
    dispatch.reset_launches()
    with RoutingLog() as card_log:
        card = train_cli.run_training(cfg, device="cuda", **run)
        torch.cuda.synchronize()
    launches = {k: dispatch.launch_counts()[k] for k in TRAIN_KERNELS}
    with RoutingLog() as cpu_log:
        cpu = train_cli.run_training(cfg, device="cpu", **run)
    diff = routing_diff(card_log, cpu_log)
    per_step = cfg.num_layers   # one routing call a layer a step (no remat, no eval)
    held = run["steps"] if not diff["differ"] else diff["first_call"] // per_step
    rel = [abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"])]
    wstd_rel = abs(card["final_weight_std"] - cpu["final_weight_std"]) / cpu["final_weight_std"]
    same_pairs = len(card["partners"]) == 2 and all(
        np.array_equal(a, b) for a, b in zip(card["partners"], cpu["partners"]))
    row = {"loss_max_rel_diff": max(rel), "loss_rel_diff": rel, "losses_held_steps": held,
           "weight_std_rel_diff": wstd_rel, "partner_tables_identical": same_pairs,
           "routing": diff, "launches": launches, "card_losses": card["losses"],
           "cpu_losses": cpu["losses"], "seconds": time.perf_counter() - t0}
    log("train granite-moe-1b-a400m fp32 card vs cpu reduced: " + json.dumps(row))
    if not same_pairs:
        raise AssertionError("granite: card and CPU runs paired replicas differently")
    if min(launches.values()) <= 0:
        raise AssertionError(f"granite fp32 card training skipped a kernel: {launches}")
    near_ties_only(diff, "granite training")
    if max(rel[:held], default=0.0) > LOSS_RTOL or (not diff["differ"] and wstd_rel > WSTD_RTOL):
        raise AssertionError(f"granite: card and CPU training differ: losses {rel}, "
                             f"wstd {wstd_rel:.3e}")
    return row


def archs_parity(dev) -> dict:
    """One loss-and-gradient evaluation of each other newly registered
    arch's reduced() config in fp32 (2 × 64 tokens) on the card and on the
    CPU from the same weights: the loss within LOSS_RTOL, each gradient leaf
    within GRAD_NORM_RTOL of its largest magnitude, the flash kernels
    launched, and for qwen3-moe the routing decisions that differ counted."""
    out = {}
    for arch in OTHER_ARCHS:
        cfg = registry.get_config(arch).reduced(dtype="float32", remat=False)
        cpu_params = M.init_params(torch.Generator().manual_seed(0), cfg)
        toks = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, size=(2, 65)).astype(np.int32))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        res = {}
        for key, device, params in (("card", dev, _tree_to(cpu_params, dev)),
                                    ("cpu", torch.device("cpu"), cpu_params)):
            params = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
            dispatch.reset_launches()
            with RoutingLog() as rlog:
                loss, parts = M.loss_fn(params, cfg, {k: v.to(device) for k, v in batch.items()})
                loss.backward()
            res[key] = (loss.item(), parts["aux_loss"].item(),
                        [t.grad.cpu() for t in tree_leaves(params)], rlog,
                        {k: dispatch.launch_counts()[k] for k in TRAIN_KERNELS[:2]})
        (gl, ga, gg, glog, launches), (cl, ca, cg, clog, _) = res["card"], res["cpu"]
        grad_rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                       for a, b in zip(gg, cg))
        diff = routing_diff(glog, clog)
        row = {"loss_card": gl, "loss_cpu": cl, "loss_rel_diff": abs(gl - cl) / abs(cl),
               "aux_card": ga, "aux_cpu": ca, "grad_max_normwise_diff": grad_rel,
               "routing": diff, "launches": launches}
        log(f"loss and grads fp32 card vs cpu {arch} reduced: " + json.dumps(row))
        if min(launches.values()) <= 0:
            raise AssertionError(f"{arch}: the card run skipped a flash kernel: {launches}")
        near_ties_only(diff, arch)
        if not diff["differ"] and (row["loss_rel_diff"] > LOSS_RTOL or grad_rel > GRAD_NORM_RTOL):
            raise AssertionError(f"{arch}: card and CPU differ: {row}")
        out[arch] = row
    return out


# ---------------------------------------------------------------------------
# Phases 26–29: the encoder-decoder and vision models, the dense KV cache
# ---------------------------------------------------------------------------

WHISPER = whisper_base.CONFIG
INTERNVL = internvl2_76b.CONFIG
# This slice's flash calls, (B, Sq, Sk, H, KV, D, mode): whisper-base's
# encoder (1,500 frames, full), cross-attention (448 queries over 1,500
# frames, full) and decoder self-attention (448, causal), 4 replicas ×
# batch 4 folded into B; internvl2-76b's layers (64/8 heads of 128) over 256
# image and 768 text tokens.  Then single queries and a short prompt over
# every frame (decode-like Sq), full.
FRONTEND_FLASH = [(16, 1500, 1500, 8, 8, 64, "full"), (16, 448, 1500, 8, 8, 64, "full"),
                  (16, 448, 448, 8, 8, 64, "causal"), (1, 1024, 1024, 64, 8, 128, "causal")]
FRONTEND_FLASH_ODD = [(4, 1, 37, 8, 8, 64, "full"), (4, 5, 1500, 8, 8, 64, "full")]
WHISPER_RUN = dict(replicas=4, per_replica_batch=4, seq_len=448, steps=10, inner_steps=5,
                   inner_lr=3e-3, seed=0)
# whisper served from the dense cache: 4 rows, 4-token prompts, a cache of
# 448 positions, 64 greedy steps
WHISPER_SERVE = dict(rows=4, prompt=4, length=448, steps=64)
INTERNVL_LAYERS = 2
INTERNVL_TRAIN = dict(text=768)
INTERNVL_SERVE = dict(rows=1, prompt=32, steps=16)
# Card against CPU (phase 29): the dense-cache greedy list (the reference's
# smoke decode list plus internvl2-76b) and the whisper NoLoCo run.
DENSE_ARCHS = {"whisper-base": ("flash_attention",), "internvl2-76b": ("flash_attention",),
               "qwen3-0.6b": ("flash_attention",),
               "recurrentgemma-9b": ("flash_attention", "rglru_scan", "rglru_decode"),
               "mamba2-370m": ("ssd_chunk", "ssd_decode")}
WHISPER_PARITY_RUN = dict(replicas=4, per_replica_batch=2, seq_len=64, steps=10, inner_steps=5,
                          inner_lr=3e-3, seed=0)


def check_frontend_kernels(dev) -> dict[str, float]:
    """Phase 26: the flash pair at this slice's shapes, bf16 and fp32,
    against the plain versions; each line names the kernels that served it."""
    gen = torch.Generator(device=dev).manual_seed(26)
    errors: dict[str, float] = {}
    for dtype in (torch.bfloat16, torch.float32):
        for b, sq, sk, h, kv, d, mode in FRONTEND_FLASH + FRONTEND_FLASH_ODD:
            check_flash_case(gen, dtype, b, sq, h, kv, d, mode, 0, errors, label=" frontend",
                             sk=sk)
    return errors


def time_frontend_kernels(dev) -> dict[str, dict]:
    """Phase 26's timings: the flash pair in bf16 at FRONTEND_FLASH's
    shapes, with the CUDA-core kernels, the plain version, SDPA and the
    bound (4·Sq·Sk·D·H flops forward in full mode)."""
    gen = torch.Generator(device=dev).manual_seed(27)
    out = {}
    for b, sq, sk, h, kv, d, mode in FRONTEND_FLASH:
        label = f" B{b} S{sq}/Sk{sk} H{h}/KV{kv} D{d} {mode}"
        for name, row in time_flash(gen, b, sq, h, kv, d, label=label, sk=sk, mode=mode).items():
            out[name + label] = row
    return out


def frontend_batches(cfg, run, device, dtype, steps) -> list[dict]:
    """``steps`` training batches, made before the run: the synthetic
    loader's tokens and labels (R, B, S) beside the stub frontend's
    embeddings (``encoder_embeds`` (R, B, encoder_seq, F) or
    ``image_embeds`` (R, B, frontend_tokens, F)), normal draws of a
    generator on ``device`` seeded with the step."""
    it = shard_iterator(LoaderConfig(
        vocab_size=cfg.vocab_size, seq_len=run["seq_len"],
        per_replica_batch=run["per_replica_batch"], replicas=run["replicas"], seed=run["seed"]))
    key, n = (("encoder_embeds", cfg.encoder_seq) if cfg.is_encoder_decoder
              else ("image_embeds", cfg.frontend_tokens))
    out = []
    for step in range(steps):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in next(it).items()}
        gen = torch.Generator(device=device).manual_seed(1000 + step)
        batch[key] = torch.randn((run["replicas"], run["per_replica_batch"], n, cfg.frontend_dim),
                                 generator=gen, device=device).to(dtype)
        out.append(batch)
    return out


def gossip_run(cfg, dev, run, batches):
    """NoLoCo over ``batches`` through ``GossipProgram``, whose trainer is
    ``core/noloco.GossipTrainer`` with ``model.stacked_loss``: every replica
    starts from the seed's weights; an outer step (pairing from the
    elastic partner table) after every ``inner_steps``.  Synchronised after
    each step.  Returns (losses, step ms, synced flags, state, program)."""
    tcfg = train_cli.method_config(
        "noloco", inner_lr=run["inner_lr"], total_steps=run["steps"],
        warmup=max(run["steps"] // 10, 1), inner_steps=run["inner_steps"], seed=run["seed"])
    program = adapters.GossipProgram(cfg, tcfg, replicas=run["replicas"], seed=run["seed"],
                                     device=dev)
    state = program.init_state(None)
    losses, step_ms, synced = [], [], []
    for batch in batches:
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = program.trainer.inner_step(state, batch)
        losses.append(float(metrics["loss"].mean()))
        state, did = program.maybe_outer_step(state)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        synced.append(did)
    return losses, step_ms, synced, state, program


class FlashModeLog:
    """While entered, records the mode and the query and key lengths of
    every flash wrapper call, in order, so that a profiled step's flash
    kernels can be told apart by call (the kernels' names do not carry
    them)."""

    def __enter__(self):
        self.calls = []
        self._real = (flash_attention.flash_attention_fwd, flash_attention.flash_attention_bwd)
        fwd, bwd = self._real

        def spy_fwd(q, k, *a, mode="causal", **kw):
            self.calls.append(("fwd", f"{mode} {q.shape[1]}/{k.shape[1]}"))
            return fwd(q, k, *a, mode=mode, **kw)

        def spy_bwd(q, k, *a, mode="causal", **kw):
            self.calls.append(("bwd", f"{mode} {q.shape[1]}/{k.shape[1]}"))
            return bwd(q, k, *a, mode=mode, **kw)

        # the real wrappers count their launches on the module's names: give
        # the spies counters of their own (this run's counts were read before)
        spy_fwd.launches = spy_bwd.launches = 0
        flash_attention.flash_attention_fwd, flash_attention.flash_attention_bwd = spy_fwd, spy_bwd
        return self

    def __exit__(self, *exc):
        flash_attention.flash_attention_fwd, flash_attention.flash_attention_bwd = self._real


def flash_split_by_mode(on_card, calls) -> dict:
    """Device ms and kernel count of the flash kernels by pass, mode and
    Sq/Sk, from a profiled step's kernel events in launch order: the
    tensor-core forward is one kernel a call, its backward three (Di
    pre-pass, dK/dV, dQ)."""
    kernels = sorted((e for e in on_card if "flash_" in e.name),
                     key=lambda e: e.time_range.start)
    per_call = {"fwd": 1, "bwd": 3}
    if sum(per_call[kind] for kind, _ in calls) != len(kernels):
        return {"not measured": f"{len(kernels)} flash kernels for {len(calls)} calls"}
    out: dict[str, list] = {}
    it = iter(kernels)
    for kind, what in calls:
        row = out.setdefault(f"{kind} {what}", [0.0, 0])
        for _ in range(per_call[kind]):
            row[0] += next(it).time_range.elapsed_us() / 1e3
            row[1] += 1
    return out


def frontend_profile(program, state, batch) -> dict:
    """The outer step timed alone (median of 3), then one more inner step
    under torch.profiler: its busy share, top device ops and the flash
    kernels' ms by mode."""
    from torch.profiler import ProfilerActivity, profile

    outer_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program.trainer.outer_step(state)
        torch.cuda.synchronize()
        outer_ms.append((time.perf_counter() - t0) * 1e3)
    state, _ = program.trainer.inner_step(state, batch)   # warm
    torch.cuda.synchronize()
    with FlashModeLog() as modes, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = program.trainer.inner_step(state, batch)
        float(metrics["loss"].mean())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = span_union_ms(on_card)
    by_name: dict[str, float] = {}
    for e in on_card:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"outer_step_ms": statistics.median(outer_ms), "outer_step_samples_ms": outer_ms,
            "profiled_step_wall_ms": wall_ms,
            "device_busy_ms": busy_ms if on_card else "not measured",
            "device_busy_share": busy_ms / wall_ms if on_card else "not measured",
            "flash_ms_by_mode": flash_split_by_mode(on_card, modes.calls),
            "device_ops": len(on_card), "top_device_ops_ms": [[n[:60], t] for n, t in top],
            "weight_std_after_profile": float(metrics_lib.replica_weight_std(state.theta))}


def whisper_train_phase(dev) -> tuple[dict, dict]:
    """Phase 27, training: whisper-base at full width and depth in bf16,
    NoLoCo through GossipTrainer with model.stacked_loss (WHISPER_RUN).
    Launch counts equal the design's, losses finite and falling, the
    replicas apart; inner p50/p99, text tokens/s, the outer step alone,
    peak memory, and the profiled step."""
    cfg, run = WHISPER, WHISPER_RUN
    log(f"train {cfg.name}: {cfg.num_encoder_layers}+{cfg.num_layers}L d{cfg.d_model} "
        f"H{cfg.num_heads} frames {cfg.encoder_seq} vocab {cfg.vocab_size} {cfg.dtype} "
        f"remat={cfg.remat}: " + json.dumps(run))
    batches = frontend_batches(cfg, run, dev, torch.bfloat16, run["steps"] + 2)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    losses, step_ms, synced, state, program = gossip_run(cfg, dev, run, batches[:run["steps"]])
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = expected_launches(cfg, run, sum(synced))
    log(f"train {cfg.name} launches: " + json.dumps({k: launches[k] for k in want})
        + " expected " + json.dumps(want))
    log(f"train {cfg.name} losses: " + json.dumps(losses))
    if sum(synced) != 2 or any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"launch counts {launches} differ from the design's {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not go down: {losses}")
    inner = sorted(ms for i, ms in enumerate(step_ms) if i > 0 and not synced[i])
    p50 = statistics.median(inner)
    text_tokens = run["replicas"] * run["per_replica_batch"] * run["seq_len"]
    prof = frontend_profile(program, state, batches[-1])
    if not prof["weight_std_after_profile"] > 0:
        raise AssertionError("replicas identical after the profiled steps")
    summary = {"inner_step_p50_ms": p50, "inner_step_p99_ms": inner[-1],
               "inner_step_samples": len(inner),
               "text_tokens_per_s_steady": text_tokens / (p50 / 1e3),
               "frames_per_step": run["replicas"] * run["per_replica_batch"] * cfg.encoder_seq,
               "peak_memory_gb": peak_gb,
               "stacked_params": sum(t.numel() for t in tree_leaves(state.theta)),
               "loss_first": losses[0], "loss_last": losses[-1], "losses": losses, **prof}
    log(f"train {cfg.name} summary: " + json.dumps(summary))
    del state, program, batches
    torch.cuda.empty_cache()
    return summary, launches


def dense_greedy(params, cfg, batch, steps, length):
    """Dense-cache serving: ``prefill`` of ``batch`` (B rows), then
    ``steps`` greedy ``decode_step``s at index = prompt length (image
    patches included), each step's token the argmax of its logits.
    Synchronised around prefill and each step on the card.  Returns
    (tokens (B, steps + 1) on the host, fp32 logits of every step on the
    host, prefill ms, step ms)."""
    device = batch["tokens"].device
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    rows, n = batch["tokens"].shape
    n += batch["image_embeds"].shape[1] if "image_embeds" in batch else 0
    with torch.no_grad():
        caches = M.init_cache_tree(cfg, rows, length, device)
        sync()
        t0 = time.perf_counter()
        h, caches = M.prefill(params, cfg, batch, caches)
        logits = logits_sharded(params["embed"], cfg, h)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        toks, rows_out, step_ms = [tok], [logits[:, -1]], []
        for i in range(steps):
            t0 = time.perf_counter()
            logits, caches = M.decode_step(params, cfg, tok, n + i, caches)
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            toks.append(tok)
            rows_out.append(logits[:, -1])
    return (torch.cat(toks, 1).cpu(), torch.stack(rows_out, 1).float().cpu(), prefill_ms,
            step_ms)


def serve_summary(prefill_ms, step_ms, rows) -> dict:
    s = sorted(step_ms[1:])   # step 1 warms up
    return {"prefill_ms": prefill_ms, "decode_step_p50_ms": statistics.median(s),
            "decode_step_p99_ms": s[min(len(s) - 1, int(0.99 * len(s)))],
            "decode_steps": len(step_ms),
            "tokens_per_s": rows * len(step_ms) / (sum(step_ms) / 1e3)}


class CrossTimer:
    """While entered, brackets every cross-attention call of the plain
    blockwise function (mode "full") with CUDA events on the stream."""

    def __enter__(self):
        from repro_torch.models import attention

        self.module, self.real, self.events = attention, attention.blockwise_attention, []

        def spy(*a, mode="causal", **kw):
            if mode != "full":
                return self.real(*a, mode=mode, **kw)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.real(*a, mode=mode, **kw)
            end.record()
            self.events.append((start, end))
            return out

        attention.blockwise_attention = spy
        return self

    def __exit__(self, *exc):
        self.module.blockwise_attention = self.real

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def whisper_serve_phase(dev) -> tuple[dict, dict]:
    """Phase 27, serving: whisper-base at full width in bf16 on seed-0
    weights from the dense cache (WHISPER_SERVE): launch counts (the
    prefill's flash calls: one per encoder layer, one per decoder layer;
    decode runs the plain blockwise function), tokens in the vocabulary;
    prefill ms, decode-step p50/p99, tokens/s, peak memory; then one more
    step with each cross-attention call bracketed by CUDA events (its
    span on the stream), and the plain function alone at that shape."""
    cfg, sv = WHISPER, WHISPER_SERVE
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    gen = torch.Generator(device=dev).manual_seed(31)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (sv["rows"], sv["prompt"]), generator=gen,
                                     device=dev, dtype=torch.int32),
             "encoder_embeds": torch.randn((sv["rows"], cfg.encoder_seq, cfg.frontend_dim),
                                           generator=gen, device=dev).bfloat16()}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    tokens, _, prefill_ms, step_ms = dense_greedy(params, cfg, batch, sv["steps"], sv["length"])
    launches = dispatch.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"flash_attention": cfg.num_encoder_layers + cfg.num_layers, "flash_attention_bwd": 0}
    summary = {**serve_summary(prefill_ms, step_ms, sv["rows"]), "peak_memory_gb": peak_gb,
               "launches": {k: launches[k] for k in want}, "rows": sv["rows"],
               "prompt": sv["prompt"], "cache_length": sv["length"]}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"whisper serving launched {launches}, the design {want}")
    if not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError("whisper serving produced tokens outside the vocabulary")
    # one more step, its cross-attention calls bracketed on the stream
    with torch.no_grad():
        caches = M.init_cache_tree(cfg, sv["rows"], sv["length"], dev)
        M.prefill(params, cfg, batch, caches)
        tok = tokens[:, -1:].to(dev)
        torch.cuda.synchronize()
        with CrossTimer() as cross:
            t0 = time.perf_counter()
            M.decode_step(params, cfg, tok, sv["prompt"], caches)
            torch.cuda.synchronize()
            step = (time.perf_counter() - t0) * 1e3
        from repro_torch.models import attention
        q = torch.randn((sv["rows"], 1, cfg.num_heads, cfg.resolved_head_dim), generator=gen,
                        device=dev).bfloat16()
        ck = caches["scan"][0][1].k[0]
        kv_pos = torch.arange(ck.shape[1], device=dev)
        qpos = torch.zeros(1, dtype=torch.long, device=dev)
        expand = lambda t: attention._expand_kv(t, cfg.num_heads)
        alone = cuda_ms(lambda: attention.blockwise_attention(
            q, expand(ck), expand(ck), qpos, kv_pos, mode="full"), reps=30)[0]
    summary.update(cross_attention_step_ms=step, cross_attention_span_ms=cross.ms(),
                   cross_attention_calls=len(cross.events),
                   cross_attention_alone_ms_per_layer=alone)
    log(f"serve {cfg.name} dense cache: " + json.dumps(summary))
    del params, caches
    torch.cuda.empty_cache()
    return summary, launches


def internvl_phase(dev) -> dict:
    """Phase 28: internvl2-76b at full width with INTERNVL_LAYERS layers in
    bf16, seed-0 weights drawn on the card layer by layer into the stacked
    tree: one loss and gradient on 256 stub image embeddings and 768 text
    tokens (loss finite, every gradient finite, their norm above 0; flash
    launches as the design: one forward per layer, two under remat, one
    backward), then a dense prefill of the image and 32 tokens and 16
    greedy steps (tokens in the vocabulary).  Times and peak memory."""
    cfg = dataclasses.replace(INTERNVL, num_layers=INTERNVL_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in tree_leaves(params))
    gen = torch.Generator(device=dev).manual_seed(28)
    text = INTERNVL_TRAIN["text"]
    toks = torch.randint(0, cfg.vocab_size, (1, text + 1), generator=gen, device=dev,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "image_embeds": torch.randn((1, cfg.frontend_tokens, cfg.frontend_dim), generator=gen,
                                         device=dev).bfloat16()}
    params = tree_map(lambda t: t.requires_grad_(), params)
    times = []
    for _ in range(2):   # the first call warms up
        for t in tree_leaves(params):
            t.grad = None
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = M.loss_fn(params, cfg, batch)
        loss.backward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dispatch.launch_counts()
    grad_peak = torch.cuda.max_memory_allocated() / 1e9
    grads = [t.grad for t in tree_leaves(params)]
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    gnorm = math.sqrt(sum(float(g.float().square().sum()) for g in grads))
    want = {"flash_attention": cfg.num_layers * (2 if cfg.remat else 1),
            "flash_attention_bwd": cfg.num_layers}
    params = tree_map(lambda t: t.detach(), params)
    del grads
    for t in tree_leaves(params):
        t.grad = None
    sv = INTERNVL_SERVE
    prompt = {"tokens": toks[:sv["rows"], :sv["prompt"]],
              "image_embeds": batch["image_embeds"][:sv["rows"]]}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    length = cfg.frontend_tokens + sv["prompt"] + sv["steps"]
    tokens, _, prefill_ms, step_ms = dense_greedy(params, cfg, prompt, sv["steps"], length)
    serve_launches = dispatch.launch_counts()
    row = {"layers": cfg.num_layers, "params": n_params, "init_s": init_s,
           "init_peak_memory_gb": init_peak, "loss": loss.item(), "grad_norm": gnorm,
           "grads_finite": finite, "loss_and_grad_ms": times[-1],
           "loss_and_grad_first_ms": times[0], "loss_and_grad_peak_memory_gb": grad_peak,
           "tokens_per_step": cfg.frontend_tokens + text,
           "launches": {k: launches[k] for k in want},
           "serve": {**serve_summary(prefill_ms, step_ms, sv["rows"]),
                     "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "flash_attention_launches": serve_launches["flash_attention"],
                     "tokens": tokens[0].tolist()}}
    log(f"internvl2-76b full width {cfg.num_layers}L: " + json.dumps(row))
    if not (math.isfinite(row["loss"]) and finite and gnorm > 0):
        raise AssertionError(f"internvl2-76b loss or gradient not finite and nonzero: {row}")
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"internvl2-76b launched {launches}, the design {want}")
    if serve_launches["flash_attention"] != cfg.num_layers:
        raise AssertionError(f"internvl2-76b prefill launched {serve_launches}")
    if not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError("internvl2-76b produced tokens outside the vocabulary")
    del params, batch, prompt
    gc.collect()
    torch.cuda.empty_cache()
    return row


def frontend_inputs(cfg, rows, seq, seed) -> dict:
    """Tokens (rows, seq + 1) split into tokens and labels, with the stub
    frontend's embeddings where the model takes them, fp32, from a numpy
    seed (on the CPU, then moved: card and CPU get the same values)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(rows, seq + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encoder_decoder:
        out["encoder_embeds"] = rng.normal(size=(rows, cfg.encoder_seq, cfg.frontend_dim))
    elif cfg.frontend == "vision":
        out["image_embeds"] = rng.normal(size=(rows, cfg.frontend_tokens, cfg.frontend_dim))
    return {k: torch.from_numpy(np.ascontiguousarray(v).astype(
        np.int32 if v.dtype == np.int32 else np.float32)) for k, v in out.items()}


def frontend_parity_phase(dev) -> dict:
    """Phase 29: card against CPU on ``reduced()`` in fp32.  whisper-base and
    internvl2-76b: one loss and gradient (loss within LOSS_RTOL, each
    gradient leaf within GRAD_NORM_RTOL of its largest magnitude).  The
    dense cache, DENSE_ARCHS: 2 rows, a 12-token prompt (with the stub
    frames or patches), 8 greedy steps on the card and on the CPU from the
    same weights: identical tokens, logits within LOGIT_ATOL, and each
    kernel the dense path reaches launched.  A whisper NoLoCo run
    (WHISPER_PARITY_RUN): identical partner tables, losses within
    LOSS_RTOL."""
    cpu = torch.device("cpu")
    out: dict = {"loss": {}, "dense": {}}
    for arch in ("whisper-base", "internvl2-76b"):
        cfg = registry.get_config(arch).reduced(dtype="float32", remat=False)
        cpu_params = M.init_params(torch.Generator().manual_seed(0), cfg)
        batch = frontend_inputs(cfg, 2, 32, seed=6)
        res = {}
        for key, device, params in (("card", dev, _tree_to(cpu_params, dev)),
                                    ("cpu", cpu, cpu_params)):
            params = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
            dispatch.reset_launches()
            loss, _ = M.loss_fn(params, cfg, {k: v.to(device) for k, v in batch.items()})
            loss.backward()
            res[key] = (loss.item(), [t.grad.cpu() for t in tree_leaves(params)],
                        {k: dispatch.launch_counts()[k] for k in TRAIN_KERNELS[:2]})
        (gl, gg, launches), (cl, cg, _) = res["card"], res["cpu"]
        grad_rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                       for a, b in zip(gg, cg))
        row = {"loss_card": gl, "loss_cpu": cl, "loss_rel_diff": abs(gl - cl) / abs(cl),
               "grad_max_normwise_diff": grad_rel, "launches": launches}
        log(f"loss and grads fp32 card vs cpu {arch} reduced: " + json.dumps(row))
        if min(launches.values()) <= 0:
            raise AssertionError(f"{arch}: the card run skipped a flash kernel: {launches}")
        if row["loss_rel_diff"] > LOSS_RTOL or grad_rel > GRAD_NORM_RTOL:
            raise AssertionError(f"{arch}: card and CPU differ: {row}")
        out["loss"][arch] = row
    for arch, kernels in DENSE_ARCHS.items():
        cfg = registry.get_config(arch).reduced(dtype="float32", remat=False)
        cpu_params = M.init_params(torch.Generator().manual_seed(0), cfg)
        prompt = frontend_inputs(cfg, 2, 12, seed=7)
        del prompt["labels"]
        extra = cfg.frontend_tokens if cfg.frontend == "vision" else 0
        length = extra + 12 + 8
        dispatch.reset_launches()
        card_toks, card_logits, _, _ = dense_greedy(
            _tree_to(cpu_params, dev), cfg, {k: v.to(dev) for k, v in prompt.items()}, 8, length)
        launches = {k: dispatch.launch_counts()[k] for k in kernels}
        cpu_toks, cpu_logits, _, _ = dense_greedy(cpu_params, cfg, prompt, 8, length)
        err = (card_logits - cpu_logits).abs().max().item()
        row = {"tokens_identical": bool(torch.equal(card_toks, cpu_toks)),
               "card_tokens": card_toks.tolist(), "max_logit_diff": err, "launches": launches}
        log(f"dense cache fp32 card vs cpu {arch} reduced: " + json.dumps(row))
        if min(launches.values()) <= 0:
            raise AssertionError(f"{arch}: the dense path skipped a kernel: {launches}")
        if not row["tokens_identical"]:
            raise AssertionError(f"{arch}: card and CPU dense greedy tokens differ")
        if not (torch.isfinite(card_logits).all() and err <= LOGIT_ATOL):
            raise AssertionError(f"{arch}: card and CPU logits differ beyond tolerance")
        out["dense"][arch] = row
    cfg = WHISPER.reduced(dtype="float32", remat=False)
    run = WHISPER_PARITY_RUN
    batches = frontend_batches(cfg, run, cpu, torch.float32, run["steps"])
    dispatch.reset_launches()
    card = gossip_run(cfg, dev, run, [{k: v.to(dev) for k, v in b.items()} for b in batches])
    launches = {k: dispatch.launch_counts()[k] for k in TRAIN_KERNELS}
    host = gossip_run(cfg, cpu, run, batches)
    rel = [abs(a - b) / abs(b) for a, b in zip(card[0], host[0])]
    partners = (card[4].partners, host[4].partners)
    same_pairs = len(partners[0]) == 2 and all(
        np.array_equal(a, b) for a, b in zip(*partners))
    row = {"loss_max_rel_diff": max(rel), "partner_tables_identical": same_pairs,
           "launches": launches, "card_losses": card[0], "cpu_losses": host[0]}
    log(f"train whisper-base fp32 card vs cpu reduced: " + json.dumps(row))
    if not same_pairs:
        raise AssertionError("whisper: card and CPU runs paired replicas differently")
    if min(launches.values()) <= 0:
        raise AssertionError(f"whisper fp32 card training skipped a kernel: {launches}")
    if max(rel) > LOSS_RTOL:
        raise AssertionError(f"whisper: card and CPU training differ: losses {rel}")
    out["train"] = row
    return out


# ---------------------------------------------------------------------------
# Phases 30–32: elastic membership and asynchronous rounds
# ---------------------------------------------------------------------------

# Phase 30: paper-small-125m at full width on 8 replicas through a fault plan.
ELASTIC = dict(replicas=8, per_replica_batch=2, seq_len=1024, steps=50, inner_steps=5,
               eval_every=5, eval_batches=1, inner_lr=3e-3, seed=0)
ELASTIC_PLAN = [
    {"kind": "drop", "round": 2, "replicas": [3, 5]},
    {"kind": "rejoin", "round": 5, "replicas": [3, 5]},
    {"kind": "straggle", "round": 6, "replicas": [1], "rounds": 1},
    {"kind": "partition", "round": 7, "groups": [[0, 1, 2, 3], [4, 5, 6, 7]]},
    {"kind": "heal", "round": 9},
]
# Phase 31: a 2× straggler on its own round clock, the stale Δ discounted.
ASYNC = dict(replicas=8, per_replica_batch=2, seq_len=1024, steps=24, inner_steps=4,
             eval_every=0, inner_lr=3e-3, seed=0, stale="momentum")
ASYNC_PLAN = [{"kind": "rate", "round": 0, "replicas": [1], "rate": 0.5}]
RATE1_STEPS = 8
# Phase 32: a straggle debt that outlives the first run's horizon (steps 4–16).
STRAGGLE_PLAN = [{"kind": "straggle", "round": 1, "replicas": [1], "rounds": 3}]
INT_BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def bits_checksum(x: torch.Tensor) -> int:
    """A position-weighted sum of a tensor's raw bits in int64 (wrapping):
    equal tensors give equal sums, and a flipped bit changes the sum.
    Computed in slices, without a copy of the tensor."""
    flat = x.reshape(-1).view(INT_BITS[x.dtype])
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(0, flat.numel(), 1 << 24):
        c = flat[i:i + (1 << 24)].long()
        total += (c * torch.arange(i + 1, i + 1 + c.numel(), device=x.device)).sum()
    return int(total)


def _trees(state) -> dict:
    return {"theta": state.theta, "phi": state.outer.phi, "delta": state.outer.delta,
            "mu": state.opt.mu, "nu": state.opt.nu}


def row_checksums(state, r: int) -> dict:
    """Replica ``r``'s checksum of every leaf of θ, φ, δ and both moments,
    and its step count."""
    out = {k: [bits_checksum(x[r]) for x in tree_leaves(t)] for k, t in _trees(state).items()}
    out["count"] = int(state.opt.count[r])
    return out


def warm_started(state, r: int, source: int) -> bool:
    """Replica ``r``'s rows after a rejoin: θ and φ equal the source's φ,
    δ and both moments zero, step count 0."""
    phi = tree_leaves(state.outer.phi)
    return (all(torch.equal(t[r], p[source]) and torch.equal(p[r], p[source])
                for t, p in zip(tree_leaves(state.theta), phi))
            and not any(bool(x[r].any()) for k in ("delta", "mu", "nu")
                        for x in tree_leaves(_trees(state)[k]))
            and int(state.opt.count[r]) == 0)


def round_kind(rec: dict, world: int) -> str:
    """A round record's kind: a merged tick with a stale Δ, a straggled,
    partitioned or shrunken round, or a full one."""
    if "due" in rec:
        if any(rec["staleness"][r] for r in rec["due"]):
            return "merged tick, stale Δ discounted"
        return "merged tick, all due" if len(rec["due"]) == world else "merged tick, partial"
    if rec["absent"]:
        return "straggled"
    if rec["partition"]:
        return "partitioned"
    return f"{len(rec['active'])} active" if len(rec["active"]) < world else "full"


class ElasticProbe:
    """While entered, times ``SimCluster``'s inner and outer steps and the
    program's warm start on the host clock, synchronised before and after.
    A step is tagged "full", "masked" (a replica out of the membership),
    "partitioned" or "rejoin" (its warm start inside); a round by
    :func:`round_kind`.  ``frozen_at`` ({step: replicas}) takes those
    replicas' row checksums at the start of that step; every warm start
    takes the rejoining replica's checksums before the surgery and checks
    its rows after it (:func:`warm_started`)."""

    def __init__(self, frozen_at: dict | None = None):
        self.frozen_at = frozen_at or {}

    def __enter__(self):
        from repro_torch.sim import cluster

        self.steps, self.rounds, self.warm_ms = [], [], []
        self.frozen, self.rejoined = {}, {}
        self._real = (cluster.SimCluster.inner_step, cluster.SimCluster.maybe_outer_step,
                      adapters.GossipProgram.warm_start)
        inner, outer, warm = self._real
        probe = self

        def timed(fn, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        def spy_inner(sim, state, batch):
            t = sim.program.inner_step_index(state)
            for r in probe.frozen_at.get(t, ()):
                probe.frozen[r] = row_checksums(state, r)
            warm_before = len(probe.warm_ms)
            out, ms = timed(inner, sim, state, batch)
            kind = ("rejoin" if len(probe.warm_ms) > warm_before
                    else "masked" if not sim.program.membership.is_full
                    else "partitioned" if sim.program.partition else "full")
            probe.steps.append((t + 1, kind, ms))
            return out

        def spy_outer(sim, state):
            (state, synced), ms = timed(outer, sim, state)
            if synced:
                probe.rounds.append((sim.history[-1], ms))
            return state, synced

        def spy_warm(program, state, replica, source):
            before = row_checksums(state, replica)
            new, ms = timed(warm, program, state, replica, source)
            probe.warm_ms.append(ms)
            probe.rejoined[replica] = (before, warm_started(new, replica, source))
            return new

        (cluster.SimCluster.inner_step, cluster.SimCluster.maybe_outer_step,
         adapters.GossipProgram.warm_start) = spy_inner, spy_outer, spy_warm
        self._cluster = cluster
        return self

    def __exit__(self, *exc):
        (self._cluster.SimCluster.inner_step, self._cluster.SimCluster.maybe_outer_step,
         adapters.GossipProgram.warm_start) = self._real

    def step_ms(self) -> dict:
        """Inner step p50 / p99 ms by kind (step 1, the warm-up, left out)."""
        out = {}
        for kind in ("full", "masked", "partitioned"):
            ms = sorted(m for step, k, m in self.steps if k == kind and step > 1)
            if ms:
                out[kind] = {"p50": statistics.median(ms),
                             "p99": ms[min(len(ms) - 1, int(0.99 * len(ms)))], "n": len(ms)}
        return out

    def round_ms(self, world: int) -> dict:
        by_kind: dict[str, list] = {}
        for rec, ms in self.rounds:
            by_kind.setdefault(round_kind(rec, world), []).append(ms)
        return {k: {"median": statistics.median(v), "samples": v} for k, v in by_kind.items()}


def _compact(rounds: list[dict]) -> list[dict]:
    keys = ("round", "active", "absent", "due", "staleness", "partner", "partition")
    return [{k: r[k] for k in keys if k in r} for r in rounds]


def _elastic_launches(cfg, run, res) -> dict[str, int]:
    """``expected_launches`` for the training steps and syncs, plus the
    evals' forwards: one flash forward per attention layer an eval batch
    (as many as one step's backwards)."""
    want = expected_launches(cfg, run, res["outer_syncs"])
    evals = len(res["evals"]) * run.get("eval_batches", 0)
    want["flash_attention"] += evals * expected_launches(cfg, {"steps": 1}, 0)["flash_attention_bwd"]
    return want


def elastic_phase(dev, cfg=paper_llama.SMALL, run=ELASTIC, plan=ELASTIC_PLAN) -> tuple[dict, dict]:
    """Phase 30: ``run_elastic_training`` at full width through ``plan``:
    drop {3, 5} at round 2, rejoin at round 5 warm-started from replica 0,
    straggle {1} at round 6, partition at round 7, heal at round 9."""
    m, world = run["inner_steps"], run["replicas"]
    drop = next(e for e in plan if e["kind"] == "drop")
    rejoin = next(e for e in plan if e["kind"] == "rejoin")
    part = next(e for e in plan if e["kind"] == "partition")
    heal = next(e for e in plan if e["kind"] == "heal")
    log(f"elastic: {cfg.name} {cfg.num_layers}L d{cfg.d_model} {cfg.dtype}: " + json.dumps(run)
        + " plan " + json.dumps(plan))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    with ElasticProbe({drop["round"] * m: drop["replicas"]}) as probe:
        res = run_elastic_training(cfg, FaultPlan.build(plan), device=dev, **run)
    launches = dispatch.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = _elastic_launches(cfg, run, res)
    log("elastic launches: " + json.dumps({k: launches[k] for k in want})
        + " expected " + json.dumps(want))
    losses, rounds = res["losses"], res["rounds"]
    log("elastic losses: " + json.dumps(losses))
    log("elastic weight std at each eval: " + json.dumps(res["weight_stds"]))
    log("elastic rounds: " + json.dumps(_compact(rounds)))
    by_round = {r["round"]: r for r in rounds}
    out_ids = [i for i in range(world) if i not in drop["replicas"]]
    cut = {r: g for g, grp in enumerate(part["groups"]) for r in grp}
    checks = {
        "launches_as_designed": all(launches[k] == n for k, n in want.items()),
        "syncs": res["outer_syncs"] == run["steps"] // m,
        "losses_finite_falling": all(map(math.isfinite, losses)) and losses[-1] < losses[0],
        "dropped_rounds": all(by_round[k]["active"] == out_ids
                              and all(by_round[k]["partner"][r] == r for r in drop["replicas"])
                              for k in range(drop["round"], rejoin["round"])),
        "partition_rounds_within_islands": all(
            all(cut[i] == cut[p] for i, p in enumerate(by_round[k]["partner"]))
            for k in range(part["round"], heal["round"])),
        "membership": res["membership"] == {"epoch": 2, "active": list(range(world))},
        "frozen_rows_bit_identical": sorted(probe.rejoined) == sorted(drop["replicas"]) and all(
            probe.frozen[r] == probe.rejoined[r][0] for r in drop["replicas"]),
        "rejoined_rows_warm_started": all(ok for _, ok in probe.rejoined.values()),
    }
    state = res.pop("state")
    prof = profile_steps(cfg, state, dev, run)
    del state
    summary = {
        "inner_step_ms": probe.step_ms(), "outer_step_ms": probe.round_ms(world),
        "warm_start_ms": probe.warm_ms, "peak_memory_gb": peak_gb,
        "outer_syncs": res["outer_syncs"], "membership": res["membership"],
        "loss_first": losses[0], "loss_last": losses[-1], "final_weight_std": res["final_weight_std"],
        "evals": res["evals"], "wall_s": res["wall_s"], "checks": checks,
        "outer_step_ms_full_alone": prof["outer_step_ms"],
        **{k: prof[k] for k in ("device_busy_ms", "device_busy_share", "profiled_step_wall_ms",
                                "flash_kernels_ms", "top_device_ops_ms")},
    }
    log("elastic summary: " + json.dumps(summary))
    del res
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"elastic phase failed its checks: {checks}")
    return summary, launches


def async_phase(dev, cfg=paper_llama.SMALL, run=ASYNC, plan=ASYNC_PLAN) -> dict:
    """Phase 31: the 2× straggler on its own clock at full width, the merged
    ticks timed beside the synchronous outer step (``time_outer`` on the
    same state); then a rate-1 world against the synchronous run of the
    same steps, bit for bit, under both stale rules."""
    world = run["replicas"]
    log("async: " + json.dumps(run) + " plan " + json.dumps(plan))
    gc.collect()
    torch.cuda.empty_cache()
    dispatch.reset_launches()
    with ElasticProbe() as probe:
        res = run_elastic_training(cfg, FaultPlan.build(plan), device=dev, **run)
    launches = dispatch.launch_counts()
    want = _elastic_launches(cfg, run, res)
    log("async launches: " + json.dumps({k: launches[k] for k in want})
        + " expected " + json.dumps(want))
    log("async rounds: " + json.dumps(_compact(res["rounds"])))
    involution = all(r["partner"][r["partner"][i]] == i
                     for r in res["rounds"] for i in set(r["active"]) - set(r["absent"]))
    sync_outer = time_outer(cfg, res.pop("state"), dev)["none"]
    base = {k: v for k, v in run.items() if k != "stale"}
    base["steps"] = RATE1_STEPS
    sync = run_elastic_training(cfg, FaultPlan(), device=dev, **base)
    theta = sync.pop("state").theta
    rate1 = {}
    for stale in ("naive", "momentum"):
        a = run_elastic_training(cfg, FaultPlan(), device=dev, async_clock=True, stale=stale, **base)
        rate1[stale] = {
            "losses_identical": a["losses"] == sync["losses"],
            "theta_bit_identical": all(torch.equal(x, y) for x, y in zip(
                tree_leaves(a["state"].theta), tree_leaves(theta))),
            "max_staleness": a["max_staleness"], "blocked_syncs": a["blocked_syncs"]}
        del a
    del theta
    torch.cuda.empty_cache()
    checks = {
        "launches_as_designed": all(launches[k] == n for k, n in want.items()),
        "max_staleness_1": res["max_staleness"] == 1, "blocked_syncs_0": res["blocked_syncs"] == 0,
        "involution": involution, "losses_finite": all(map(math.isfinite, res["losses"])),
        "rate1_bit_identical": all(r["losses_identical"] and r["theta_bit_identical"]
                                   and r["max_staleness"] == 0 for r in rate1.values()),
    }
    summary = {"merged_tick_ms": probe.round_ms(world),
               "sync_outer_step_ms": statistics.median(sync_outer),
               "sync_outer_step_samples_ms": sync_outer, "inner_step_ms": probe.step_ms(),
               "merged_ticks": res["outer_syncs"], "max_staleness": res["max_staleness"],
               "blocked_syncs": res["blocked_syncs"], "losses": res["losses"],
               "rate1_vs_sync": rate1, "rate1_losses": sync["losses"], "checks": checks}
    log("async summary: " + json.dumps(summary))
    if not all(checks.values()):
        raise AssertionError(f"async phase failed its checks: {checks}")
    return summary


def _rel(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def elastic_parity_phase(dev) -> dict:
    """Phase 32: phases 30 and 31's plans on ``reduced()`` in fp32, on the
    card and on the CPU (identical round histories, losses within
    LOSS_RTOL, weight std within WSTD_RTOL); then two resumes on the card,
    each bit-identical to its uninterrupted run: mid-straggle (the debt
    outlives the first run's horizon) and mid-async."""
    cfg = paper_llama.SMALL.reduced(dtype="float32", remat=False)
    small = dict(per_replica_batch=2, seq_len=64)
    out, card_runs = {}, {}
    for name, run, plan in (("elastic", {**ELASTIC, **small}, ELASTIC_PLAN),
                            ("async", {**ASYNC, **small}, ASYNC_PLAN)):
        dispatch.reset_launches()
        card = run_elastic_training(cfg, FaultPlan.build(plan), device=dev, **run)
        torch.cuda.synchronize()
        launches = dispatch.launch_counts()
        cpu = run_elastic_training(cfg, FaultPlan.build(plan), device="cpu", **run)
        wstd = [w for _, w in card["weight_stds"]] + [card["final_weight_std"]]
        cpu_wstd = [w for _, w in cpu["weight_stds"]] + [cpu["final_weight_std"]]
        out[name] = {"rounds_identical": card["rounds"] == cpu["rounds"],
                     "loss_max_rel_diff": _rel(card["losses"], cpu["losses"]),
                     "weight_std_max_rel_diff": _rel(wstd, cpu_wstd),
                     "launches": {k: launches[k] for k in TRAIN_KERNELS}}
        card_runs[name] = card
        del cpu
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_elastic")
    straggle = dict(ELASTIC, **small, steps=24, total_steps=24, inner_steps=4, eval_every=0)
    resumes = (("mid-straggle", straggle, STRAGGLE_PLAN, 8, None),
               ("mid-async", dict(ASYNC, **small, total_steps=24), ASYNC_PLAN, 13,
                card_runs["async"]))
    for name, run, plan, mid, full in resumes:
        shutil.rmtree(d, ignore_errors=True)
        plan = FaultPlan.build(plan)
        full = full or run_elastic_training(cfg, plan, device=dev, **run)
        run_elastic_training(cfg, plan, device=dev, ckpt_dir=d, **{**run, "steps": mid})
        sim = ckpt_lib.restore(d, mid)["program"]["sim"]
        cont = run_elastic_training(cfg, plan, device=dev, ckpt_dir=d, resume=True, **run)
        same = {k: all(torch.equal(a, b) for a, b in zip(tree_leaves(x), tree_leaves(y)))
                for k, x, y in zip(("theta", "phi", "delta"), (
                    cont["state"].theta, cont["state"].outer.phi, cont["state"].outer.delta), (
                    full["state"].theta, full["state"].outer.phi, full["state"].outer.delta))}
        out[name] = {"start_step": cont["start_step"], "straggle_owed": sim["straggle"].tolist(),
                     "clock": "clock" in sim,
                     "losses_identical": cont["losses"] == full["losses"][mid:],
                     "rounds_identical": cont["rounds"] == full["rounds"][-len(cont["rounds"]):],
                     "bit_identical": same}
    shutil.rmtree(d, ignore_errors=True)
    log("elastic fp32 card vs cpu and resumes: " + json.dumps(out))
    for name in ("elastic", "async"):
        row = out[name]
        if not (row["rounds_identical"] and row["loss_max_rel_diff"] <= LOSS_RTOL
                and row["weight_std_max_rel_diff"] <= WSTD_RTOL
                and min(row["launches"].values()) > 0):
            raise AssertionError(f"{name}: card and CPU runs differ: {row}")
    for name in ("mid-straggle", "mid-async"):
        row = out[name]
        if not (row["losses_identical"] and row["rounds_identical"]
                and all(row["bit_identical"].values())):
            raise AssertionError(f"{name}: the resumed run differs from the uninterrupted one: {row}")
    if not any(out["mid-straggle"]["straggle_owed"]) or not out["mid-async"]["clock"]:
        raise AssertionError(f"the checkpoints did not hold the in-flight state: {out}")
    return out


# ---------------------------------------------------------------------------
# Phases 33–35: streaming outer steps with the φ-prefetch overlap
# ---------------------------------------------------------------------------

# Phase 33: phase 6's run for 15 steps with 4 staggered streams and the
# overlap: syncs at inner steps 5–8, 10–13 and 15 on streams 0–3, 0–3, 0.
STREAMS = 4
STREAM_RUN = dict(TRAIN, steps=15)
STREAM_SYNCS = dict(steps=[5, 6, 7, 8, 10, 11, 12, 13, 15], streams=[0, 1, 2, 3, 0, 1, 2, 3, 0])
# Phase 34: tests/test_streaming.py's churn plan at full width: replica 3
# drops at step 9 and rejoins at step 17 (m 4: every step from 4 syncs a
# stream).
STREAM_CHURN = dict(replicas=8, per_replica_batch=2, seq_len=1024, steps=28, inner_steps=4,
                    eval_every=0, inner_lr=3e-3, seed=0, stream_count=STREAMS)
STREAM_CHURN_PLAN = [{"kind": "drop", "step": 9, "replicas": [3]},
                     {"kind": "rejoin", "step": 17, "replicas": [3]}]
# Phase 35: core/theory.py's quadratic model, card against CPU.  The two
# draw their normals through erfinv implementations that may differ in the
# last bits; the trajectories are held within THEORY_RTOL.
THEORY = dict(world=8, outer_steps=40, inner_steps=5, seed=0)
THEORY_DIM = 32
THEORY_RATES = (1.0,) * 7 + (0.5,)
THEORY_RTOL = 1e-4
STREAM_MID = 7   # a resume between stream 1's and stream 2's syncs


class StreamProbe:
    """While entered, times each stream sync and each inner step of
    ``GossipProgram`` on the host clock, synchronised before and after, and
    records the kernel launches of each sync."""

    def __enter__(self):
        self.syncs, self.inner_ms = [], []
        self._real = (adapters.GossipProgram._maybe_stream_sync, adapters.GossipProgram.inner_step)
        sync, inner = self._real
        probe = self

        def spy_sync(program, state):
            k = program._schedule.due(program.inner_step_index(state))
            before = dispatch.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, synced = sync(program, state)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = dispatch.launch_counts()
            if synced:
                probe.syncs.append({"stream": k, "ms": ms, "launches": {
                    n: after[n] - before[n] for n in after if after[n] != before[n]}})
            return state, synced

        def spy_inner(program, state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(program, state, batch)
            torch.cuda.synchronize()
            probe.inner_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        adapters.GossipProgram._maybe_stream_sync = spy_sync
        adapters.GossipProgram.inner_step = spy_inner
        return self

    def __exit__(self, *exc):
        adapters.GossipProgram._maybe_stream_sync, adapters.GossipProgram.inner_step = self._real

    def ms_by_stream(self) -> dict:
        out: dict[int, list] = {}
        for rec in self.syncs:
            out.setdefault(rec["stream"], []).append(rec["ms"])
        return {k: {"median": statistics.median(v), "samples": v} for k, v in sorted(out.items())}


def _stream_subs(cfg):
    """One replica's parameter leaves of each stream (nothing allocated)."""
    tree = bytes_model.abstract_params(cfg)
    leaves = tree_leaves(tree)
    part = payload.stream_partition(tree, STREAMS)
    return part, [[leaves[i] for i in part.leaf_indices(k)] for k in range(STREAMS)]


def stream_launches(cfg, run: dict, events: list[dict], codec: str) -> dict[str, int]:
    """Launches the design implies for a streamed run: the flash pair as
    ``expected_launches`` counts it; one update per leaf of each synced
    stream; on the int8 wire one quantize and one dequantize per buffer of
    what each sync moves (the fused (Δ_k, φ_k) when it blocks, Δ_k when it
    consumes its prefetch) and of its φ′_k pre-send."""
    want = expected_launches(cfg, run, 0)
    _, subs = _stream_subs(cfg)
    want["noloco_update"] = sum(len(subs[ev["stream"]]) for ev in events)
    n = 0
    if codec == "int8":
        for ev in events:
            sub = subs[ev["stream"]]
            moved = (sub, sub) if ev["blocked"] else sub
            n += len(payload.make_spec(moved).buffers) + len(payload.make_spec(sub).buffers)
    want["int8_quantize"] = want["int8_dequantize"] = n
    return want


def _events(jsonl: str, kind: str) -> list[dict]:
    return [e for e in map(json.loads, open(jsonl)) if e["event"] == kind]


def _jsonl(name: str) -> str:
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    return path


def time_stream_cycle(cfg, state, dev, codec: str, reps: int = 3) -> dict:
    """On one state: each stream's sync alone (synchronised), the first
    cycle blocking and pre-sending, the later ones consuming their
    prefetch; each stream's φ′ pre-send alone; and the full outer step of
    ``time_outer`` beside them."""
    tcfg = train_cli.method_config("noloco", inner_lr=3e-3, total_steps=10, warmup=1,
                                   inner_steps=5,
                                   comm=CommConfig(codec=codec, streams=STREAMS, overlap=True))
    program = adapters.GossipProgram(cfg, tcfg, replicas=TRAIN["replicas"], device=dev)
    world = TRAIN["replicas"]
    phi_pre, cycles, presend = None, [], {k: [] for k in range(STREAMS)}
    phi = tree_leaves(state.outer.phi)
    for rep in range(reps):
        per = []
        for k in range(STREAMS):
            i = rep * STREAMS + k
            nxt = pairing.partner_table(i + STREAMS, world)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, phi_pre = program.trainer.outer_step_stream(
                state, stream=k, partition=program._partition,
                partner=pairing.partner_table(i, world), phi_pre=phi_pre,
                consume_prefetch=rep > 0, partner_next=nxt)
            torch.cuda.synchronize()
            per.append((time.perf_counter() - t0) * 1e3)
            del new
            leaves = [phi[j] for j in program._partition.leaf_indices(k)]
            comm = exchange.StackedGather(torch.as_tensor(nxt, device=dev), tcfg.comm)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sent = exchange.presend(comm, leaves)
            torch.cuda.synchronize()
            presend[k].append((time.perf_counter() - t0) * 1e3)
            del sent
        cycles.append(per)
    full = time_outer(cfg, state, dev)
    steady = [sum(c) for c in cycles[1:]]
    return {"cycle_ms_blocking": sum(cycles[0]), "cycle_ms_consuming": statistics.median(steady),
            "sync_ms_by_stream": {k: [c[k] for c in cycles] for k in range(STREAMS)},
            "presend_ms_by_stream": presend,
            "full_outer_step_ms": statistics.median(full[codec]),
            "full_outer_step_samples_ms": full[codec]}


def stream_train_phase(dev, codec: str, phase6: dict) -> tuple[dict, dict]:
    """Phase 33 for one wire: paper-small-125m at full width, 4 × 4 ×
    1024, m 5, 4 streams with the overlap, 15 steps."""
    cfg = paper_llama.SMALL
    label = f"stream {codec}"
    run = dict(STREAM_RUN, codec=codec)
    log(f"{label}: {cfg.name} streams {STREAMS} overlap: " + json.dumps(run))
    jsonl = _jsonl(f"chip_smoke_stream_{codec}.jsonl")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    with StreamProbe() as probe:
        res = train_cli.run_training(cfg, device="cuda", streams=STREAMS, overlap=True,
                                     log_jsonl=jsonl, **run)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    events = _events(jsonl, "stream_sync")
    want = stream_launches(cfg, run, events, codec)
    log(f"{label} launches: " + json.dumps({k: launches[k] for k in want})
        + " expected " + json.dumps(want))
    log(f"{label} events: " + json.dumps([{k: e[k] for k in (
        "step", "stream", "sync_index", "payload_bytes", "blocking_bytes", "blocked",
        "epoch_fallback")} for e in events]))
    cost = bytes_model.outer_step_cost(
        bytes_model.abstract_params(cfg),
        CommConfig(codec=codec, streams=STREAMS, overlap=True), world=TRAIN["replicas"])
    per = cost.per_stream
    losses = res["losses"]
    log(f"{label} losses: " + json.dumps(losses))
    seen: set[int] = set()
    first = []
    for e in events:
        first.append(e["stream"] not in seen)
        seen.add(e["stream"])
    stream0 = [r for r in probe.syncs if r["stream"] == 0]
    checks = {
        "schedule": [e["step"] for e in events] == STREAM_SYNCS["steps"]
        and [e["stream"] for e in events] == STREAM_SYNCS["streams"]
        and [e["sync_index"] for e in events] == list(range(len(events))),
        "first_blocks_later_consume": [e["blocked"] for e in events] == first
        and not any(e["epoch_fallback"] for e in events),
        "bytes_as_byte_model": all(
            e["payload_bytes"] == per[e["stream"]].payload_bytes
            and e["blocking_bytes"] == (per[e["stream"]].payload_bytes if e["blocked"]
                                        else per[e["stream"]].blocking_bytes) for e in events)
        and res["comm_bytes"] == sum(e["payload_bytes"] for e in events),
        "stream0_empty": per[0].payload_bytes == 0 and len(stream0) == 3
        and all(not r["launches"] for r in stream0),
        "launches_as_designed": all(launches[k] == n for k, n in want.items()),
        "losses_finite_falling": all(map(math.isfinite, losses)) and losses[-1] < losses[0],
    }
    inner = sorted(probe.inner_ms[1:])
    steps = _events(jsonl, "step")
    state = res.pop("state")
    cycle = time_stream_cycle(cfg, state, dev, codec)
    del state
    summary = {
        "inner_step_p50_ms": statistics.median(inner),
        "inner_step_p99_ms": inner[min(len(inner) - 1, int(0.99 * len(inner)))],
        "inner_step_p50_ms_phase6": phase6["inner_step_p50_ms"],
        "step_dt_ms": [e["dt_s"] * 1e3 for e in steps],
        "sync_ms_in_run": probe.ms_by_stream(),
        "sync_launches_in_run": [{k: r[k] for k in ("stream", "launches")} for r in probe.syncs],
        **cycle,
        "peak_memory_gb": peak_gb, "peak_memory_gb_phase6": phase6["peak_memory_gb"],
        "phi_pre_gb": payload.make_spec(bytes_model.abstract_params(cfg)).nbytes
        * TRAIN["replicas"] / 1e9,
        "comm_bytes": res["comm_bytes"], "blocking_bytes": res["blocking_bytes"],
        "blocking_fraction": res["blocking_fraction"],
        "byte_model_steady_blocking_fraction": cost.blocking_bytes / cost.payload_bytes,
        "per_stream_bytes": [dataclasses.asdict(s) for s in per],
        "loss_first": losses[0], "loss_last": losses[-1],
        "final_weight_std": res["final_weight_std"], "wall_s": res["wall_s"], "checks": checks,
    }
    log(f"{label} summary: " + json.dumps(summary))
    del res
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"{label} failed its checks: {checks}")
    return summary, launches


def stream1_overlap_phase(dev, phase6_losses: list[float]) -> dict:
    """Phase 33's last check: one stream with the overlap at phase 6's own
    run gives phase 6's losses bit for bit (φ does not change during the
    inner steps, so the prefetched φ is the one the blocking exchange
    would have gathered)."""
    dispatch.reset_launches()
    res = train_cli.run_training(paper_llama.SMALL, device="cuda", streams=1, overlap=True,
                                 **TRAIN)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    out = {"losses_identical": res["losses"] == phase6_losses, "losses": res["losses"],
           "blocking_fraction": res["blocking_fraction"],
           "launches": {k: launches[k] for k in TRAIN_KERNELS}}
    log("stream 1 overlap vs phase 6: " + json.dumps(out))
    del res
    torch.cuda.empty_cache()
    if not out["losses_identical"]:
        raise AssertionError("one stream with the overlap differs from phase 6's run")
    return out


def stream_epochs(jsonl: str) -> list[tuple[int, int]]:
    """(first step, epoch) of each membership view of a run's events."""
    return [(0, 0)] + [(e["step"], e["epoch"]) for e in _events(jsonl, "membership")]


def _epoch_at(views, step: int) -> int:
    return [epoch for first, epoch in views if step >= first][-1]


def stream_churn_phase(dev, cfg=paper_llama.SMALL, run=STREAM_CHURN,
                       plan=STREAM_CHURN_PLAN) -> tuple[dict, dict]:
    """Phase 34: the streamed run through a drop and a rejoin at full width:
    a stream falls back to the blocking exchange at most once per
    membership change, and at least one does."""
    log("stream churn: " + json.dumps(run) + " plan " + json.dumps(plan))
    jsonl = _jsonl("chip_smoke_stream_churn.jsonl")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    with StreamProbe() as probe:
        res = run_elastic_training(cfg, FaultPlan.build(plan), device=dev, log_jsonl=jsonl, **run)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    events = _events(jsonl, "stream_sync")
    want = stream_launches(cfg, run, events, "none")
    log("stream churn launches: " + json.dumps({k: launches[k] for k in want})
        + " expected " + json.dumps(want))
    views = stream_epochs(jsonl)
    fallbacks = [(e["step"], e["stream"]) for e in events if e["epoch_fallback"]]
    by_epoch: dict[int, list[int]] = {}
    for step, k in fallbacks:
        by_epoch.setdefault(_epoch_at(views, step), []).append(k)
    log("stream churn fallbacks (step, stream): " + json.dumps(fallbacks)
        + " membership views " + json.dumps(views))
    drop = plan[0]["replicas"]
    rounds = res["rounds"]
    checks = {
        "fallback_once_per_stream_per_change": all(len(v) == len(set(v)) for v in by_epoch.values())
        and 0 not in by_epoch,
        "some_fallback": len(fallbacks) > 0,
        "syncs": len(events) == run["steps"] - run["inner_steps"] + 1 == res["outer_syncs"],
        "dropped_self_paired": all(r["partner"][d] == d for r in rounds
                                   if not set(drop) & set(r["active"]) for d in drop),
        "membership": res["membership"] == {"epoch": 2, "active": list(range(run["replicas"]))},
        "launches_as_designed": all(launches[k] == n for k, n in want.items()),
        "losses_finite": all(map(math.isfinite, res["losses"])),
    }
    summary = {"fallbacks": fallbacks, "fallbacks_by_epoch": by_epoch,
               "sync_ms_in_run": probe.ms_by_stream(),
               "inner_step_p50_ms": statistics.median(sorted(probe.inner_ms[1:])),
               "blocking_fraction": res["blocking_fraction"], "peak_memory_gb": peak_gb,
               "losses": res["losses"], "final_weight_std": res["final_weight_std"],
               "wall_s": res["wall_s"], "checks": checks}
    log("stream churn summary: " + json.dumps(summary))
    del res
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"stream churn failed its checks: {checks}")
    return summary, launches


def stream_parity_phase(dev) -> dict:
    """Phase 35: card against CPU on ``reduced()`` in fp32: the streamed run
    on the plain and the int8 wire and the streamed churn (identical
    ``stream_sync`` events, partner tables and rounds, losses within
    LOSS_RTOL, weight std within WSTD_RTOL), ``theory.simulate_quadratic``
    synchronous and with rates (within THEORY_RTOL; the card's outer steps
    launch ``noloco_update``), and a resume mid-stream on the card,
    bit-identical to the uninterrupted run."""
    from repro_torch.core import theory

    cfg = paper_llama.SMALL.reduced(dtype="float32", remat=False)
    small = dict(replicas=4, per_replica_batch=2, seq_len=64, steps=15, total_steps=15,
                 inner_steps=5, eval_every=0, inner_lr=3e-3, seed=0)
    out, card_runs = {}, {}
    for name in ("none", "int8", "churn"):
        runs, logs = {}, {}
        dispatch.reset_launches()
        for where in ("cuda", "cpu"):
            logs[where] = _jsonl(f"chip_smoke_stream_parity_{name}_{where}.jsonl")
            if name == "churn":
                runs[where] = run_elastic_training(
                    cfg, FaultPlan.build(STREAM_CHURN_PLAN), device=where, log_jsonl=logs[where],
                    **{**STREAM_CHURN, "per_replica_batch": 2, "seq_len": 64})
            else:
                runs[where] = train_cli.run_training(cfg, device=where, codec=name,
                                                     streams=STREAMS, overlap=True,
                                                     log_jsonl=logs[where], **small)
            if where == "cuda":
                torch.cuda.synchronize()
                launches = dispatch.launch_counts()
        card, cpu = runs["cuda"], runs["cpu"]
        ev = {w: [{k: v for k, v in e.items() if k != "run"} for e in _events(logs[w], "stream_sync")]
              for w in logs}
        out[name] = {
            "stream_events_identical": ev["cuda"] == ev["cpu"] and len(ev["cuda"]) > 0,
            "partner_tables_identical": len(card["partners"]) == len(cpu["partners"]) and all(
                np.array_equal(a, b) for a, b in zip(card["partners"], cpu["partners"])),
            "rounds_identical": card.get("rounds") == cpu.get("rounds"),
            "loss_max_rel_diff": _rel(card["losses"], cpu["losses"]),
            "weight_std_rel_diff": _rel([card["final_weight_std"]], [cpu["final_weight_std"]]),
            "fallbacks": sum(e["epoch_fallback"] for e in ev["cuda"]),
            "launches": {k: launches[k] for k in TRAIN_KERNELS + (INT8 if name == "int8" else ())}}
        card_runs[name] = card
        del cpu
    theory_out = {}
    model = theory.QuadraticModel(a_eigs=tuple(np.linspace(0.05, 1.0, THEORY_DIM)))
    for name, rates in (("sync", None), ("rates", THEORY_RATES)):
        dispatch.reset_launches()
        card = theory.simulate_quadratic(model, rates=rates, device=dev, **THEORY)
        torch.cuda.synchronize()
        n = dispatch.launch_counts()["noloco_update"]
        cpu = theory.simulate_quadratic(model, rates=rates, device="cpu", **THEORY)
        theory_out[name] = {
            "max_rel_diff": {k: float(np.max(np.abs(card[k] - cpu[k]) / np.maximum(
                np.abs(cpu[k]), 1e-30))) for k in ("mean_norm", "replica_std", "var")},
            "staleness_identical": bool(np.array_equal(card.get("staleness", 0),
                                                       cpu.get("staleness", 0))),
            "noloco_update_launches": n, "mean_norm_last": float(card["mean_norm"][-1])}
    out["theory"] = theory_out
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_stream")
    shutil.rmtree(d, ignore_errors=True)
    full = card_runs["none"]
    train_cli.run_training(cfg, device=dev, streams=STREAMS, overlap=True, ckpt_dir=d,
                           **{**small, "steps": STREAM_MID})
    stream_tree = ckpt_lib.restore(d, STREAM_MID)["program"]["stream"]
    cont = train_cli.run_training(cfg, device=dev, streams=STREAMS, overlap=True, ckpt_dir=d,
                                  resume=True, **small)
    same = {k: all(torch.equal(a, b) for a, b in zip(tree_leaves(x), tree_leaves(y)))
            for k, x, y in zip(("theta", "phi", "delta"), (
                cont["state"].theta, cont["state"].outer.phi, cont["state"].outer.delta), (
                full["state"].theta, full["state"].outer.phi, full["state"].outer.delta))}
    out["mid-stream"] = {"start_step": cont["start_step"],
                         "pre_epoch": stream_tree["pre_epoch"].tolist(),
                         "phi_pre_in_checkpoint": "phi_pre" in stream_tree,
                         "losses_identical": cont["losses"] == full["losses"][STREAM_MID:],
                         "bit_identical": same}
    shutil.rmtree(d, ignore_errors=True)
    log("stream fp32 card vs cpu and resume: " + json.dumps(out))
    for name in ("none", "int8", "churn"):
        row = out[name]
        if not (row["stream_events_identical"] and row["partner_tables_identical"]
                and row["rounds_identical"] and row["loss_max_rel_diff"] <= LOSS_RTOL
                and row["weight_std_rel_diff"] <= WSTD_RTOL
                and min(row["launches"].values()) > 0):
            raise AssertionError(f"stream {name}: card and CPU runs differ: {row}")
    if out["churn"]["fallbacks"] == 0:
        raise AssertionError("the streamed churn run fell back nowhere")
    for name, row in theory_out.items():
        if max(row["max_rel_diff"].values()) > THEORY_RTOL or not row["staleness_identical"] \
                or row["noloco_update_launches"] <= 0:
            raise AssertionError(f"theory {name}: card and CPU differ: {row}")
    row = out["mid-stream"]
    if not (row["start_step"] == STREAM_MID and row["phi_pre_in_checkpoint"]
            and row["losses_identical"] and all(row["bit_identical"].values())):
        raise AssertionError(f"the mid-stream resume differs from the uninterrupted run: {row}")
    return out


# ---------------------------------------------------------------------------
# Phases 36–38: the routed pipeline
# ---------------------------------------------------------------------------

# Phase 36: 2 stages × 4 replicas of paper-small-125m at full width, 4 ×
# 1024 a replica, NoLoCo m 5, 15 steps (syncs after steps 5, 10 and 15).
PIPE_RUN = dict(stages=2, replicas=4, per_replica_batch=4, seq_len=1024, steps=15,
                inner_steps=5, lr=3e-3, seed=0)
# Phase 37: 4 stages of 3 layers, the plain wire, 10 steps.
PIPE4_RUN = dict(PIPE_RUN, stages=4, steps=10)
# One replica's (Δ, φ) payload of all its stages, either split.
PIPE_BYTES = {"none": 1_126_477_824, "int8": 567_561_816}
# Phase 38: card against CPU on reduced() in fp32.
PIPE_SMALL = dict(PIPE_RUN, per_replica_batch=2, seq_len=64, steps=12)
PIPE_MID = 6
# The launches the design gives, written out: 12 layers a step whatever the
# split, two flash forwards a layer under remat and one backward; one update
# per leaf of every stage a sync (24 leaves in 2 stages, 44 in 4); on the
# int8 wire a bf16 and an fp32 buffer in each stage's payload.
PIPE_DESIGN = {
    "none": {"flash_attention": 360, "flash_attention_bwd": 180, "noloco_update": 72,
             "int8_quantize": 0, "int8_dequantize": 0},
    "int8": {"flash_attention": 360, "flash_attention_bwd": 180, "noloco_update": 72,
             "int8_quantize": 12, "int8_dequantize": 12},
    "4x4": {"flash_attention": 240, "flash_attention_bwd": 120, "noloco_update": 88,
            "int8_quantize": 0, "int8_dequantize": 0},
}


class PipeProbe:
    """While entered, times each inner and each outer step of
    ``PipelineProgram`` on the host clock, synchronised before and after."""

    def __enter__(self):
        self.inner_ms, self.outer_ms = [], []
        self._real = (adapters.PipelineProgram.inner_step, adapters.PipelineProgram.maybe_outer_step)
        inner, outer = self._real
        probe = self

        def spy_inner(program, state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(program, state, batch)
            torch.cuda.synchronize()
            probe.inner_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def spy_outer(program, state):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, synced = outer(program, state)
            torch.cuda.synchronize()
            if synced:
                probe.outer_ms.append((time.perf_counter() - t0) * 1e3)
            return state, synced

        adapters.PipelineProgram.inner_step = spy_inner
        adapters.PipelineProgram.maybe_outer_step = spy_outer
        return self

    def __exit__(self, *exc):
        adapters.PipelineProgram.inner_step, adapters.PipelineProgram.maybe_outer_step = self._real


def pipe_trainer(cfg, dev, run, codec="none", method="noloco", routing="random", elastic=None):
    outer = None if method == "none" else OuterConfig(method=method,
                                                      inner_steps=run["inner_steps"],
                                                      seed=run["seed"])
    return PipelineTrainer(cfg, num_stages=run["stages"], replicas=run["replicas"],
                           inner=AdamWConfig(lr=run["lr"], weight_decay=0.0), routing=routing,
                           outer=outer, comm=CommConfig(codec=codec), device=dev,
                           seed=run["seed"], elastic=elastic)


def pipe_loop(trainer, cfg, run, **loop_kw):
    loader = LoaderConfig(vocab_size=cfg.vocab_size, seq_len=run["seq_len"],
                          per_replica_batch=run["per_replica_batch"], replicas=run["replicas"],
                          seed=run["seed"])
    loop_kw.setdefault("steps", run["steps"])
    return make_loop(adapters.PipelineProgram(trainer), loader,
                     LoopConfig(seed=run["seed"], **loop_kw)).run()


def pipe_launches(cfg, run, syncs: int, codec: str) -> dict[str, int]:
    """Launches the design implies: each stage's flash pair as its own
    stack's (remat: two forwards a layer), one update per leaf of every
    stage a sync and, on the int8 wire, one quantize and one dequantize per
    float buffer of each stage's (Δ, φ) payload."""
    out = {"flash_attention": 0, "flash_attention_bwd": 0}
    for scfg in split_stages(cfg, run["stages"]):
        per_stage = expected_launches(scfg, run, 0)
        for k in out:
            out[k] += per_stage[k]
    trees = [bytes_model.abstract_stage_params(cfg, s, run["stages"]) for s in range(run["stages"])]
    buffers = sum(len(payload.make_spec((t, t)).buffers) for t in trees) if codec == "int8" else 0
    out["noloco_update"] = syncs * sum(len(tree_leaves(t)) for t in trees)
    out["int8_quantize"] = out["int8_dequantize"] = syncs * buffers
    return out


def _op_device_ms(events, name: str, shape: list[int]) -> tuple[float, int]:
    """Device ms and count of the profiled host ops ``name`` whose first
    input has ``shape`` (the profiler's attribution of kernels to ops)."""
    total, n = 0.0, 0
    for e in events:
        if e.name == name and e.input_shapes and list(e.input_shapes[0]) == shape:
            us = getattr(e, "device_time_total", None)
            total += (us if us is not None else e.cuda_time_total) / 1e3
            n += 1
    return total, n


def profile_pipe_step(trainer, state, batch, dev) -> dict:
    """One more inner step under torch.profiler on the trained state: busy
    share, the top device ops, and the route gathers (``index_select`` of
    the (R, B, S, d) activations) forward and backward (``index_add_``);
    each gather also timed alone."""
    from torch.profiler import ProfilerActivity, profile

    state, _ = trainer.train_step(state, batch)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    on_card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in on_card) / 1e3
    by_name: dict[str, float] = {}
    for e in on_card:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    r, b, s, d = (trainer.replicas, batch["tokens"].shape[1], batch["tokens"].shape[2],
                  trainer.cfg.d_model)
    shape = [r, b, s, d]
    fwd_ms, fwd_n = _op_device_ms(events, "aten::index_select", shape)
    bwd_ms, bwd_n = _op_device_ms(events, "aten::index_add_", shape)
    x = torch.randn(shape, device=dev).to(torch.bfloat16)
    idx = torch.tensor(trainer.routes(0)[0], device=dev)
    zeros = torch.zeros_like(x)
    alone_fwd = cuda_ms(lambda: x.index_select(0, idx), reps=20)[0]
    alone_bwd = cuda_ms(lambda: zeros.zero_().index_add_(0, idx, x), reps=20)[0]
    return {
        "profiled_step_wall_ms": wall_ms,
        "device_busy_ms": busy_ms if on_card else "not measured",
        "device_busy_share": busy_ms / wall_ms if on_card else "not measured",
        "device_ops": len(on_card),
        "top_device_ops_ms": [[n[:60], t] for n, t in top],
        "route_gather_fwd_ms_in_step": fwd_ms if fwd_n else "not measured",
        "route_gather_bwd_ms_in_step": bwd_ms if bwd_n else "not measured",
        "route_gathers_in_step": [fwd_n, bwd_n],
        "route_gather_fwd_ms_alone": alone_fwd,
        "route_gather_bwd_ms_alone": alone_bwd,
        "route_gather_mb": x.numel() * x.element_size() / 1e6,
    }


def time_pipe_outer(trainer, state, reps: int = 3) -> dict:
    """The outer step alone on the trained state (synchronised before and
    after, median of ``reps``): round k - 1 again, due at this step."""
    again = dict(state, outer=dict(state["outer"], step=state["outer"]["step"] - 1))
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.maybe_outer_step(again)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"outer_step_ms_alone": statistics.median(times), "outer_step_samples_ms": times}


def pipe_train_phase(dev, design: str, codec: str = "none", run=PIPE_RUN,
                     phase6: dict | None = None) -> tuple[dict, dict]:
    """Phases 36 and 37: paper-small-125m at full width in bf16 through
    ``make_loop(PipelineProgram(...))``: launch counts as designed, comm
    bytes the byte model's, routes permutations that vary, losses finite
    and falling; inner and outer step times, peak memory, a profiled
    inner step."""
    cfg = paper_llama.SMALL
    label = f"pipe {run['stages']}x{run['replicas']} {codec}"
    log(f"{label}: {cfg.name} {cfg.num_layers}L d{cfg.d_model} {cfg.dtype} remat={cfg.remat}: "
        + json.dumps({**run, "codec": codec}))
    jsonl = _jsonl(f"chip_smoke_{label.replace(' ', '_')}.jsonl")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = pipe_trainer(cfg, dev, run, codec=codec)
    dispatch.reset_launches()
    with PipeProbe() as probe:
        res = pipe_loop(trainer, cfg, run, log_jsonl=jsonl)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    syncs = res["outer_syncs"]
    want = pipe_launches(cfg, run, syncs, codec)
    log(f"{label} launches: " + json.dumps({k: launches[k] for k in want})
        + " expected " + json.dumps(want) + " design " + json.dumps(PIPE_DESIGN[design]))
    losses = res["losses"]
    log(f"{label} losses: " + json.dumps(losses))
    routes = [[r.tolist() for r in trainer.routes(t)] for t in range(run["steps"])]
    state = res.pop("state")
    stage_keys = [sorted(p) for p in state["params"]]
    checks = {
        "syncs": syncs == run["steps"] // run["inner_steps"],
        "launches_as_designed": all(launches[k] == n for k, n in want.items())
        and want == PIPE_DESIGN[design],
        "comm_bytes": res["comm_bytes"] == syncs * PIPE_BYTES[codec]
        and res["comm"]["payload_bytes"] == PIPE_BYTES[codec],
        "losses_finite_falling": all(map(math.isfinite, losses)) and losses[-1] < losses[0],
        "routes_permutations": all(sorted(r) == list(range(run["replicas"]))
                                   for step in routes for r in step),
        # the reference's draw may repeat a route on consecutive steps (steps
        # 2-4 of seed 0 at 4 replicas do, as in JAX): held over the run
        "routes_vary": len({json.dumps(step) for step in routes}) > run["steps"] // 2,
        "stage_keys": stage_keys[0] == ["embed", "stack"]
        and stage_keys[-1] == ["final_norm", "stack", "unembed"]
        and all(k == ["stack"] for k in stage_keys[1:-1]),
    }
    inner = sorted(probe.inner_ms[1:])
    outer = time_pipe_outer(trainer, state)
    batch = next(shard_iterator(LoaderConfig(
        vocab_size=cfg.vocab_size, seq_len=run["seq_len"], per_replica_batch=run["per_replica_batch"],
        replicas=run["replicas"]), start_step=run["steps"]))
    prof = profile_pipe_step(trainer, state, batch, dev)
    params = sum(t.numel() for t in tree_leaves(state["params"]))
    del state
    tokens = run["replicas"] * run["per_replica_batch"] * run["seq_len"]
    p50 = statistics.median(inner)
    summary = {
        "inner_step_p50_ms": p50,
        "inner_step_p99_ms": inner[min(len(inner) - 1, int(0.99 * len(inner)))],
        "inner_step_samples": len(inner),
        "tokens_per_s_steady": tokens / (p50 / 1e3),
        "outer_step_ms_in_run": probe.outer_ms, **outer,
        "peak_memory_gb": peak_gb, "stacked_params": params,
        "comm_bytes": res["comm_bytes"], "outer_syncs": syncs,
        "loss_first": losses[0], "loss_last": losses[-1],
        "final_weight_std": res["final_weight_std"], "wall_s": res["wall_s"],
        "routes_first_steps": routes[:4],
        "routes_distinct": len({json.dumps(step) for step in routes}), **prof, "checks": checks,
    }
    if phase6 is not None:
        summary["inner_step_p50_ms_phase6"] = phase6["inner_step_p50_ms"]
        summary["peak_memory_gb_phase6"] = phase6["peak_memory_gb"]
    log(f"{label} summary: " + json.dumps(summary))
    del res, trainer
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"{label} failed its checks: {checks}")
    return summary, launches


def _pipe_state_leaves(state) -> list[torch.Tensor]:
    return (tree_leaves(state["params"])
            + [t for o in state["opt"] for t in tree_leaves(o.mu) + tree_leaves(o.nu) + [o.count]]
            + tree_leaves(state["outer"]["phi"]) + tree_leaves(state["outer"]["delta"]))


def _pipe_elastic(cfg, device, batches):
    """``tests/test_elastic.py``'s pipeline scenario: m 2, replica 2
    dropped after two batches; routes, losses, tables, replica 2's rows at
    the drop and at the end."""
    ctx = ElasticContext(world=PIPE_SMALL["replicas"])
    tr = pipe_trainer(cfg, device, dict(PIPE_SMALL, inner_steps=2), elastic=ctx)
    state, routes, losses, snap = tr.init(), [], [], None
    for i, b in enumerate(batches):
        if i == 2:
            ctx.set_membership(ctx.membership.drop([2]))
            snap = [t[2].clone() for t in _pipe_state_leaves(state)]
        routes.append([r.tolist() for r in tr.routes(state["step"])])
        state, loss = tr.train_step(state, b)
        losses.append(loss)
        state, _ = tr.maybe_outer_step(state)
    frozen = all(torch.equal(a, t[2]) for a, t in zip(snap, _pipe_state_leaves(state)))
    return {"routes": routes, "losses": losses, "tables": [[t.tolist() for t in r]
                                                          for r in tr.partners],
            "frozen_rows_bit_identical": frozen, "weight_std": tr.weight_std(state)}


def pipe_parity_phase(dev) -> dict:
    """Phase 38: card against CPU on ``reduced()`` in fp32, the same initial
    weights (drawn on the CPU, then moved): NoLoCo on the plain and the int8
    wire, ``method="none"`` with fixed routing, the elastic drop of replica
    2 (identical routes and tables, losses within LOSS_RTOL, weight std
    within WSTD_RTOL on the plain wire; replica 2's rows on the card
    bit-identical from the drop on), a resume at step 6 on the card
    bit-identical to the uninterrupted card run, and one loss and gradient
    of recurrentgemma-9b's ``reduced()`` in 2 stages (the RG-LRU scan and
    its backward launched)."""
    cfg = paper_llama.SMALL.reduced(dtype="float32", remat=False)
    out, card_runs = {}, {}
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_pipe")
    shutil.rmtree(d, ignore_errors=True)
    for name, codec, method, routing in (("noloco", "none", "noloco", "random"),
                                         ("int8", "int8", "noloco", "random"),
                                         ("none-fixed", "none", "none", "fixed")):
        runs, tables = {}, {}
        for where in ("cuda", "cpu"):
            tr = pipe_trainer(cfg, where, PIPE_SMALL, codec=codec, method=method, routing=routing)
            kw = {"ckpt_dir": d, "ckpt_every": PIPE_MID} if (where, name) == ("cuda", "noloco") else {}
            if where == "cuda":
                dispatch.reset_launches()
            runs[where] = pipe_loop(tr, cfg, PIPE_SMALL, **kw)
            if where == "cuda":
                torch.cuda.synchronize()
                launches = dispatch.launch_counts()
            tables[where] = [[t.tolist() for t in r] for r in tr.partners]
            routes = [[r.tolist() for r in tr.routes(t)] for t in range(PIPE_SMALL["steps"])]
            runs[where]["routes"] = routes
        card, cpu = runs["cuda"], runs["cpu"]
        kernels = TRAIN_KERNELS if method != "none" else TRAIN_KERNELS[:2]
        out[name] = {
            "routes_identical": card["routes"] == cpu["routes"],
            "partner_tables_identical": tables["cuda"] == tables["cpu"]
            and len(tables["cuda"]) == (0 if method == "none" else 2),
            "loss_max_rel_diff": _rel(card["losses"], cpu["losses"]),
            "weight_std_rel_diff": _rel([card["final_weight_std"]], [cpu["final_weight_std"]]),
            "launches": {k: launches[k] for k in kernels + (INT8 if codec == "int8" else ())}}
        card_runs[name] = card
        del cpu
    it = shard_iterator(LoaderConfig(vocab_size=cfg.vocab_size, seq_len=PIPE_SMALL["seq_len"],
                                     per_replica_batch=2, replicas=PIPE_SMALL["replicas"]))
    batches = [next(it) for _ in range(8)]
    dispatch.reset_launches()
    card = _pipe_elastic(cfg, dev, batches)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    cpu = _pipe_elastic(cfg, "cpu", batches)
    out["elastic"] = {
        "routes_identical": card["routes"] == cpu["routes"],
        "dropped_routed_to_itself": all(step[0][2] == 2 for step in card["routes"][2:]),
        "partner_tables_identical": card["tables"] == cpu["tables"] and len(card["tables"]) == 4,
        "loss_max_rel_diff": _rel(card["losses"], cpu["losses"]),
        "weight_std_rel_diff": _rel([card["weight_std"]], [cpu["weight_std"]]),
        "frozen_rows_bit_identical": card["frozen_rows_bit_identical"],
        "launches": {k: launches[k] for k in TRAIN_KERNELS}}
    full = card_runs["noloco"]
    mid = d + "_mid"   # the step-6 checkpoint alone (the run also saved step 12)
    shutil.rmtree(mid, ignore_errors=True)
    name = f"step_{PIPE_MID:08d}"
    shutil.copytree(os.path.join(d, name), os.path.join(mid, name))
    cont = pipe_loop(pipe_trainer(cfg, dev, PIPE_SMALL), cfg, PIPE_SMALL, ckpt_dir=mid,
                     resume=True)
    out["resume"] = {"start_step": cont["start_step"],
                     "losses_identical": cont["losses"] == full["losses"][PIPE_MID:],
                     "bit_identical": all(torch.equal(a, b) for a, b in zip(
                         _pipe_state_leaves(cont["state"]), _pipe_state_leaves(full["state"])))}
    shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(mid, ignore_errors=True)
    # recurrentgemma-9b's reduced() in 2 stages: one loss and gradient
    rg = registry.get_config("recurrentgemma-9b").reduced(dtype="float32", remat=False)
    batch = next(shard_iterator(LoaderConfig(vocab_size=rg.vocab_size, seq_len=64,
                                             per_replica_batch=2, replicas=4)))
    route = [np.array([2, 3, 0, 1])]
    res = {}
    for where in ("cuda", "cpu"):
        tr = pipe_trainer(rg, where, PIPE_SMALL)
        params = [tree_map(lambda t: t.detach().requires_grad_(), p) for p in tr.init()["params"]]
        dispatch.reset_launches()
        loss = tr.loss(params, batch, route)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        if where == "cuda":
            torch.cuda.synchronize()
            rg_launches = {k: dispatch.launch_counts()[k] for k in ("rglru_scan", "rglru_scan_bwd")}
        res[where] = (loss.item(), [g.cpu() for g in grads])
    (gl, gg), (cl, cg) = res["cuda"], res["cpu"]
    out["recurrentgemma"] = {
        "loss_card": gl, "loss_cpu": cl, "loss_rel_diff": abs(gl - cl) / abs(cl),
        "grad_max_normwise_diff": max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                                      for a, b in zip(gg, cg)),
        "launches": rg_launches}
    log("pipe fp32 card vs cpu and resume: " + json.dumps(out))
    for name in ("noloco", "int8", "none-fixed", "elastic"):
        row = out[name]
        plain = name != "int8"
        if not (row["routes_identical"] and row["partner_tables_identical"]
                and row["loss_max_rel_diff"] <= LOSS_RTOL
                and (not plain or row["weight_std_rel_diff"] <= WSTD_RTOL)
                and min(row["launches"].values()) > 0):
            raise AssertionError(f"pipe {name}: card and CPU runs differ: {row}")
    if not (out["elastic"]["frozen_rows_bit_identical"] and out["elastic"]["dropped_routed_to_itself"]):
        raise AssertionError(f"pipe elastic: the dropped replica moved: {out['elastic']}")
    row = out["resume"]
    if not (row["start_step"] == PIPE_MID and row["losses_identical"] and row["bit_identical"]):
        raise AssertionError(f"pipe resume differs from the uninterrupted run: {row}")
    row = out["recurrentgemma"]
    if not (row["loss_rel_diff"] <= LOSS_RTOL and row["grad_max_normwise_diff"] <= GRAD_NORM_RTOL
            and min(row["launches"].values()) > 0):
        raise AssertionError(f"pipe recurrentgemma-9b: card and CPU differ: {row}")
    return out


# ---------------------------------------------------------------------------
# Phases 39–43: the rest of serving
# ---------------------------------------------------------------------------

SPEC_K = 4
# the truncated drafts at full width: half the layers, recurrentgemma-9b's
# cut to a whole number of its (rglru, rglru, local) periods
# phase 40's targets at cut depth, and their truncated drafts
SPEC_LAYERS = {"qwen3-0.6b": 14, "mamba2-370m": 24, "recurrentgemma-9b": 20}
SPEC_DRAFT_LAYERS = {"qwen3-0.6b": 7, "mamba2-370m": 12, "recurrentgemma-9b": 9}
SERVE_KERNELS = ("paged_attention", "paged_chunk_attention", "flash_attention",
                 "rglru_scan", "rglru_decode", "ssd_chunk", "ssd_decode")
DECODE_KERNEL = {"global": "paged_attention", "local": "paged_attention",
                 "rglru": "rglru_decode", "ssd": "ssd_decode"}
CHUNK_KERNEL = {"global": "paged_chunk_attention", "local": "paged_chunk_attention",
                "rglru": "rglru_scan", "ssd": "ssd_chunk"}
WHOLE_KERNEL = dict(CHUNK_KERNEL, **{"global": "flash_attention", "local": "flash_attention"})
# a bf16 token flip must be a near tie in the reference run: at most four
# bf16 ulps of a logit in [8, 16) between its top two logits
BF16_FLIP_MARGIN = 0.25
# the speculative runs and the fp32 single-shot runs take the phase-4 mix's
# first four requests (prompts 24/80/200/24, 16/32 new)
HALF_MIX = dict(SERVE_MIX, n=4)
SPEC_PARITY_MIX = dict(n=4, prompt_lens=[80, 200], gen_lens=[16, 12], temps=[0.0, 0.7])


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def design_launches(cfgs, per_layer: dict[str, str], n: int, into=None) -> dict[str, int]:
    """Every serving kernel's launches when each layer of each config in
    ``cfgs`` launches its kernel of ``per_layer`` ``n`` times."""
    out = dict.fromkeys(SERVE_KERNELS, 0) if into is None else into
    for cfg in cfgs:
        for kind in cfg.layer_types:
            out[per_layer[kind]] += n
    return out


def counted_run(params, cfg, scfg, requests, draft=None) -> tuple[dict, dict, dict]:
    """One ``serve_run`` with the launch counts zeroed just before and read
    just after: (tokens by rid, summary with peak memory, launches)."""
    finished = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    summary = serve_run(
        params, cfg, scfg, [dataclasses.replace(r) for r in requests], draft=draft,
        spec_k=SPEC_K,
        log=lambda ev: finished.update({ev["rid"]: ev["tokens"]}) if ev["event"] == "finish" else None,
    )
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    summary["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for r in requests:
        if len(finished.get(r.rid, [])) != r.max_new:
            raise AssertionError(f"{cfg.name} request {r.rid}: "
                                 f"{len(finished.get(r.rid, []))} of {r.max_new} tokens")
    return finished, summary, launches


def reference_margin(params, cfg, scfg, request, index: int) -> float:
    """The reference engine's own margin between its top two logits (noisy,
    at the request's temperature) where it sampled token ``index`` of
    ``request``, read from a run of the request alone (batched == solo)."""
    from repro_torch.serve import engine as serve_engine

    seen = {}
    real = serve_engine._sample

    def recording(logits, draws):
        for row, d in enumerate(draws):
            if d is not None and d[1] == request.rid and d[2] == index:
                top = serve_engine._perturb(logits[row:row + 1], [d])[0].topk(2).values
                seen["margin"] = float(top[0] - top[1])
        return real(logits, draws)

    serve_engine._sample = recording
    try:
        ServeEngine(params, cfg, scfg).run([dataclasses.replace(request)])
    finally:
        serve_engine._sample = real
    return seen["margin"]


def token_flips(params, cfg, scfg, requests, got: dict, want: dict) -> list[dict]:
    """Each request whose tokens differ from ``want`` (the plain engine's
    under ``scfg``): the first index where they part, both tokens, and the
    plain engine's margin between its top two logits there."""
    flips = []
    for r in requests:
        a, b = got[r.rid], want[r.rid]
        if a == b:
            continue
        i = next(j for j in range(len(b)) if a[j] != b[j])
        flips.append({"rid": r.rid, "index": i, "temperature": r.temperature, "got": a[i],
                      "want": b[i], "top2_margin": reference_margin(params, cfg, scfg, r, i)})
    return flips


def check_flips(what: str, cfg, flips: list[dict]) -> None:
    """fp32 allows no flip; a bf16 flip is printed with its margin and must
    be a near tie (BF16_FLIP_MARGIN): two computations of one function (the
    flash op against the paged chunk kernel, a GEMM over 16 rows against
    one over 4) round differently in bf16, and 24–48 layers carry the
    difference to the logits."""
    if flips:
        log(f"{what}: tokens part on {len(flips)} request(s): " + json.dumps(flips))
    if flips and cfg.dtype != "bfloat16":
        raise AssertionError(f"{what}: {cfg.dtype} tokens differ: {flips}")
    wide = [f for f in flips if f["top2_margin"] > BF16_FLIP_MARGIN]
    if wide:
        raise AssertionError(f"{what}: bf16 flips past a near tie: {wide}")


def serve_mix(cfg, temps, mix=SERVE_MIX):
    return synth_requests(mix["n"], cfg.vocab_size, mix["prompt_lens"], mix["gen_lens"],
                          list(temps), seed=0)


def single_shot_phase(dev) -> tuple[dict, dict]:
    """qwen3-0.6b and mamba2-370m at full width in bf16, then in fp32, with
    the phase-4 mix, chunked and single-shot (``prefill_chunk=0``) on the
    same weights: the same tokens (fp32: no flip; a bf16 flip printed with
    its margin), the single-shot run's launches as the design's (one flash
    forward per attention layer or one SSD chunk call per SSD layer per
    request, no paged chunk call; the decode kernels per step), TTFT
    p50/p99 of both."""
    out, launches_all = {}, dict.fromkeys(SERVE_KERNELS, 0)
    depth = [cut(c, SINGLE_SHOT_LAYERS) for c in (qwen3_0_6b.CONFIG, mamba2_370m.CONFIG)]
    for base in (*depth, *(dataclasses.replace(c, dtype="float32") for c in depth)):
        t0 = time.perf_counter()
        params = M.init_params(torch.Generator(device=dev).manual_seed(0), base)
        requests = serve_mix(base, [0.0], SERVE_MIX if base.dtype == "bfloat16" else HALF_MIX)
        scfg = ServeConfig(**SERVE_CFG)
        whole_cfg = dataclasses.replace(scfg, prefill_chunk=0)
        for c in (scfg, whole_cfg):
            ServeEngine(params, base, c).run([dataclasses.replace(requests[0], max_new=2)])
        chunked, c_sum, _ = counted_run(params, base, scfg, requests)
        whole, w_sum, launches = counted_run(params, base, whole_cfg, requests)
        want = design_launches([base], WHOLE_KERNEL, len(requests))
        design_launches([base], DECODE_KERNEL, w_sum["decode_steps"], into=want)
        flips = token_flips(params, base, scfg, requests, whole, chunked)
        label = f"{base.name} {base.dtype}"
        row = {"card": card(), "dtype": base.dtype, "requests": len(requests),
               "launches": {k: launches[k] for k in SERVE_KERNELS}, "launches_design": want,
               "tokens_equal": not flips, "flips": flips,
               **{f"{k}_single_shot": w_sum[k] for k in (
                   "ttft_p50_s", "ttft_p99_s", "tokens_per_s", "step_p50_s", "wall_s",
                   "peak_memory_gb")},
               **{f"{k}_chunked": c_sum[k] for k in (
                   "ttft_p50_s", "ttft_p99_s", "tokens_per_s", "step_p50_s", "wall_s",
                   "peak_memory_gb")},
               "phase_seconds": time.perf_counter() - t0}
        log(f"single-shot {label}: " + json.dumps(row))
        check_flips(f"single-shot {label}", base, flips)
        if row["launches"] != want:
            raise AssertionError(f"single-shot {label}: launches {row['launches']} "
                                 f"differ from the design's {want}")
        for k in SERVE_KERNELS:
            launches_all[k] += launches[k]
        out[label] = row
        del params
        torch.cuda.empty_cache()
    return out, launches_all


def spec_phase(dev, base, variants) -> tuple[dict, dict]:
    """Speculative decode of ``base`` at full width in its dtype, spec_k 4,
    on seed-0 weights with the phase-4 mix's first four requests, against
    the plain engine on the same weights: for each variant (label, draft layers or None for the
    target itself, temperatures) the tokens (a flip printed with its
    request, index and margin), launches as the design's (per round
    spec_k decode-kernel launches per layer of the draft and of the
    target's verify; per prefill chunk one chunk call per layer of both),
    tokens/s, rounds, accept_rate and peak memory beside the plain run's."""
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), base)
    scfg = ServeConfig(**SERVE_CFG)
    warm = serve_mix(base, [0.0], HALF_MIX)[0]
    SpecServeEngine(params, base, scfg, *truncate_layers(params, base, 1), spec_k=SPEC_K).run(
        [dataclasses.replace(warm, max_new=3)])
    plain: dict = {}
    out, launches_all = {}, dict.fromkeys(SERVE_KERNELS, 0)
    for label, layers, temps in variants:
        requests = serve_mix(base, temps, HALF_MIX)
        if tuple(temps) not in plain:
            plain[tuple(temps)] = counted_run(params, base, scfg, requests)
        p_tokens, p_sum, _ = plain[tuple(temps)]
        draft = (params, base) if layers is None else truncate_layers(params, base, layers)
        tokens, summ, launches = counted_run(params, base, scfg, requests, draft=draft)
        chunk_calls = sum(-(-len(r.prompt) // scfg.prefill_chunk) for r in requests)
        want = design_launches([base, draft[1]], DECODE_KERNEL, SPEC_K * summ["spec_rounds"])
        design_launches([base, draft[1]], CHUNK_KERNEL, chunk_calls, into=want)
        flips = token_flips(params, base, scfg, requests, tokens, p_tokens)
        row = {"card": card(), "dtype": base.dtype, "draft_layers": draft[1].num_layers, "temps": list(temps),
               "tokens_equal": not flips, "flips": flips, "spec_rounds": summ["spec_rounds"],
               "accept_rate": summ["accept_rate"], "launches": {k: launches[k] for k in SERVE_KERNELS},
               "launches_design": want,
               **{f"{k}_spec": summ[k] for k in ("tokens_per_s", "wall_s", "step_p50_s",
                                                 "step_p99_s", "ttft_p50_s", "peak_memory_gb")},
               **{f"{k}_plain": p_sum[k] for k in ("tokens_per_s", "wall_s", "decode_steps",
                                                  "step_p50_s", "ttft_p50_s", "peak_memory_gb")},
               "phase_seconds": time.perf_counter() - t0}
        label = f"{label} {base.dtype}"
        log(f"spec {base.name} {label}: " + json.dumps(row))
        check_flips(f"spec {base.name} {label}", base, flips)
        if layers is None and not flips and summ["accept_rate"] != 1.0:
            raise AssertionError(f"spec {base.name} self-draft: accept_rate {summ['accept_rate']}")
        if row["launches"] != want:
            raise AssertionError(f"spec {base.name} {label}: launches {row['launches']} "
                                 f"differ from the design's {want}")
        for k in SERVE_KERNELS:
            launches_all[k] += launches[k]
        out[label] = row
    del params, draft
    torch.cuda.empty_cache()
    return out, launches_all


def spec_runs():
    """Phase 40's runs: (config, [(label, draft layers or None, temperatures)]),
    each family in bf16 and then, with its truncated draft, in fp32."""
    runs = []
    for base in (qwen3_0_6b.CONFIG, mamba2_370m.CONFIG, recurrentgemma_9b.CONFIG):
        base = cut(base, SPEC_LAYERS)
        layers = SPEC_DRAFT_LAYERS[base.name]
        variants = [("truncated", layers, [0.0])]
        if base.name == qwen3_0_6b.CONFIG.name:
            variants = [("self", None, [0.0]), *variants, ("truncated sampled", layers, [0.0, 0.7])]
        runs.append((base, variants))
    for base, _ in list(runs):
        runs.append((dataclasses.replace(base, dtype="float32"),
                     [("truncated", SPEC_DRAFT_LAYERS[base.name], [0.0])]))
    return runs


def spec_cli_phase(dev, ckpt_dir: str) -> dict:
    """``repro_torch.launch.serve --ckpt <phase 11's checkpoint> --replica 1
    --spec-decode --draft-replica 2 --verify`` on the card and on the CPU
    (paper-small-125m reduced, fp32): no mismatch against the plain engine
    on either, card tokens equal CPU tokens."""
    args = ["--arch", "paper-small-125m", "--ckpt", ckpt_dir, "--replica", "1", "--spec-decode",
            "--draft-replica", "2", "--verify", "--requests", "4", "--max-batch", "4",
            "--prompt-lens", "24,80", "--gen-lens", "16,12", "--temps", "0.0,0.7"]
    t0 = time.perf_counter()
    logs = {d: os.path.join(ckpt_dir, f"spec_{d}.jsonl") for d in ("cuda", "cpu")}
    runs = {d: serve_cli.main([*args, "--device", d, "--log-jsonl", logs[d]]) for d in logs}
    tokens = {d: {e["rid"]: e["tokens"] for e in map(json.loads, open(p)) if e["event"] == "finish"}
              for d, p in logs.items()}
    out = {"card": card(), "tokens_identical": tokens["cuda"] == tokens["cpu"],
           **{f"{k}_{d}": runs[d][k] for d in runs for k in (
               "verify_mismatches", "accept_rate", "spec_rounds", "tokens_per_s")},
           "draft": runs["cuda"]["draft"], "phase_seconds": time.perf_counter() - t0}
    log("spec CLI ensemble draft card vs cpu: " + json.dumps(out))
    if out["verify_mismatches_cuda"] or out["verify_mismatches_cpu"] or not out["tokens_identical"]:
        raise AssertionError(f"spec CLI: {out}")
    if len(tokens["cuda"]) != 4 or out["accept_rate_cuda"] != out["accept_rate_cpu"]:
        raise AssertionError(f"spec CLI: card and CPU runs differ: {out}")
    return out


def plain_least_loaded(requests, n: int) -> list[int]:
    """The replica of each request under least-loaded routing of a batch
    submitted at once: the smallest pending prompt + budget, ties to the
    lowest index."""
    load, out = [0] * n, []
    for r in requests:
        i = load.index(min(load))
        load[i] += len(r.prompt) + r.max_new
        out.append(i)
    return out


def router_phase(dev) -> dict:
    """Two engines of qwen3-0.6b at full width in bf16 on one card, on seed-0
    and seed-1 weights, the phase-4 mix at temperatures 0.0/0.7 under both
    policies: each request lands where the policy's rule puts it, and its
    tokens equal those of its engine serving it alone."""
    t0 = time.perf_counter()
    cfg = cut(qwen3_0_6b.CONFIG, QWEN3_LAYERS)
    params = [M.init_params(torch.Generator(device=dev).manual_seed(s), cfg) for s in (0, 1)]
    scfg = ServeConfig(**SERVE_CFG)
    requests = serve_mix(cfg, [0.0, 0.7])
    alone: dict = {}
    out = {"card": card()}
    for policy in ("round_robin", "least_loaded"):
        router = ReplicaRouter([ServeEngine(p, cfg, scfg) for p in params], policy=policy)
        t0 = time.perf_counter()
        finished = router.run([dataclasses.replace(r) for r in requests])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        placed = {f.rid: i for i, f in finished}
        rule = ([i % 2 for i in range(len(requests))] if policy == "round_robin"
                else plain_least_loaded(requests, 2))
        same = True
        for i, f in finished:
            key = (i, f.rid)
            if key not in alone:
                [alone[key]] = ServeEngine(params[i], cfg, scfg).run(
                    [dataclasses.replace(requests[f.rid])])
            same &= alone[key].tokens == f.tokens
        out[policy] = {"routed": router.routed, "placed": [placed[r.rid] for r in requests],
                       "rule": rule, "tokens_equal_alone": same, "wall_s": wall,
                       "tokens_per_s": sum(len(f.tokens) for _, f in finished) / wall}
        log(f"router {policy}: " + json.dumps(out[policy]))
        if out[policy]["placed"] != rule or router.routed != [rule.count(0), rule.count(1)]:
            raise AssertionError(f"router {policy}: placement {out[policy]} is not the rule's")
        if not same:
            raise AssertionError(f"router {policy}: a request's tokens differ from its engine alone")
    out["phase_seconds"] = time.perf_counter() - t0
    log("router: " + json.dumps({"card": out["card"], "phase_seconds": out["phase_seconds"]}))
    del params
    torch.cuda.empty_cache()
    return out


def spec_parity_phase(dev) -> dict:
    """The three families' ``reduced()`` configs in fp32 on the card and on
    the CPU from the same weights: speculative decode with the truncated
    one-layer draft (tokens, spec_rounds and accept_rate equal; card tokens
    equal the card's plain engine's, no flip), and single-shot prefill
    (tokens equal; on the card the flash op ran, its local mode on
    recurrentgemma-9b's window)."""
    out = {}
    mix = SPEC_PARITY_MIX
    for base in (qwen3_0_6b.CONFIG, mamba2_370m.CONFIG, recurrentgemma_9b.CONFIG):
        t0 = time.perf_counter()
        cfg = base.reduced(dtype="float32", remat=False)
        cpu_params = M.init_params(torch.Generator().manual_seed(0), cfg)
        gpu_params = _tree_to(cpu_params, dev)
        requests = synth_requests(mix["n"], cfg.vocab_size, mix["prompt_lens"],
                                  mix["gen_lens"], mix["temps"], seed=0)
        scfg = ServeConfig(**SERVE_CFG)
        row = {"card": card()}
        runs = {}
        for name, p, d in (("card", gpu_params, dev), ("cpu", cpu_params, torch.device("cpu"))):
            draft = truncate_layers(p, cfg, 1)
            engine = SpecServeEngine(p, cfg, scfg, *draft, spec_k=SPEC_K)
            dispatch.reset_launches()
            done = engine.run([dataclasses.replace(r) for r in requests])
            whole = ServeEngine(p, cfg, dataclasses.replace(scfg, prefill_chunk=0)).run(
                [dataclasses.replace(r) for r in requests])
            if d.type == "cuda":
                torch.cuda.synchronize()
                row["launches"] = {k: v for k, v in dispatch.launch_counts().items() if v}
            runs[name] = {"tokens": {f.rid: f.tokens for f in done},
                          "whole": {f.rid: f.tokens for f in whole},
                          "spec_rounds": engine.spec_rounds, "accept_rate": engine.accept_rate}
        plain = {f.rid: f.tokens for f in ServeEngine(gpu_params, cfg, scfg).run(
            [dataclasses.replace(r) for r in requests])}
        row.update({
            "spec_tokens_identical": runs["card"]["tokens"] == runs["cpu"]["tokens"],
            "single_shot_tokens_identical": runs["card"]["whole"] == runs["cpu"]["whole"],
            "spec_equals_plain_on_card": runs["card"]["tokens"] == plain,
            **{f"{k}_{d}": runs[d][k] for d in runs for k in ("spec_rounds", "accept_rate")},
            "phase_seconds": time.perf_counter() - t0})
        log(f"spec fp32 card vs cpu {cfg.name} reduced: " + json.dumps(row))
        if not (row["spec_tokens_identical"] and row["single_shot_tokens_identical"]
                and row["spec_equals_plain_on_card"]):
            raise AssertionError(f"{cfg.name}: card and CPU serving differ: {row}")
        if runs["card"]["accept_rate"] != runs["cpu"]["accept_rate"] or \
                runs["card"]["spec_rounds"] != runs["cpu"]["spec_rounds"]:
            raise AssertionError(f"{cfg.name}: card and CPU acceptance differ: {row}")
        if row["launches"].get("flash_attention", 0) <= 0 and cfg.num_layers > sum(
                k in ("rglru", "ssd") for k in cfg.layer_types):
            raise AssertionError(f"{cfg.name}: single-shot prefill skipped the flash kernel")
        out[base.name] = row
    return out


# ---------------------------------------------------------------------------
# Phases 44–48: the replica group (one rank per replica over torch.distributed)
# ---------------------------------------------------------------------------

DIST_WORLD = 4
# the full-width runs: 4 ranks × batch 4 × seq 1024, m 5, 10 steps (two syncs)
DIST_FULL = ["--data", str(DIST_WORLD), "--batch-per-replica", "4", "--seq", "1024",
             "--steps", "10", "--inner-steps", "5", "--pairing-pool", "16"]
DIST_RUNS = (("noloco", ["--method", "noloco"]), ("int8", ["--method", "noloco", "--codec", "int8"]),
             ("diloco", ["--method", "diloco"]))
# fp32 reduced on the card against the same ranks on the CPU (phase 7's run)
DIST_SMALL = ["--data", str(DIST_WORLD), "--reduced", "--batch-per-replica", "2", "--seq", "64",
              "--steps", "10", "--inner-steps", "5"]
DIST_MID = 5
DIST_PHASES = ("encode", "d2h", "wire", "h2d", "decode", "update")


def _dist_args(argv, device, backend):
    from repro_torch.launch import train_distributed

    return train_distributed.build_parser().parse_args(
        [*argv, "--device", device, "--backend", backend])


def _pct(samples, q):
    s = sorted(samples)
    return s[min(len(s) - 1, int(q * len(s)))]


def _dist_counted(trainer, group, syncs: list, inner_calls: dict):
    """Wrap the trainer's steps: the cross-rank calls made inside inner steps
    (summed into ``inner_calls``), and each sync's calls and the bytes this
    rank handed to them (``syncs``)."""
    inner_step, outer_step = trainer.inner_step, trainer.maybe_outer_step

    def delta(before: dict) -> dict:
        return {k: v - before.get(k, 0) for k, v in group.calls.items() if v - before.get(k, 0)}

    def inner(state, batch):
        before = dict(group.calls)
        out = inner_step(state, batch)
        for k, v in delta(before).items():
            inner_calls[k] = inner_calls.get(k, 0) + v
        return out

    def outer(state, **kw):
        before, sent = dict(group.calls), sum(group.sent_bytes.values())
        state, synced = outer_step(state, **kw)
        if synced:
            syncs.append({"calls": delta(before), "bytes": sum(group.sent_bytes.values()) - sent})
        return state, synced

    trainer.inner_step, trainer.maybe_outer_step = inner, outer


def dist_full_run(group, argv) -> dict:
    """One full-width run on this rank through ``run_rank`` (the CLI's
    per-rank body), launch counts zeroed just before and read just after;
    then the outer step alone, three times on the final state, each split
    into its phases by a synchronising clock."""
    from repro_torch.launch import train_distributed

    dev = group.device
    args = _dist_args(DIST_FULL + argv, "cuda", group.backend)
    trainer = train_distributed.make_trainer(args, group, dist_cfg())
    syncs: list = []
    inner_calls: dict = {}
    _dist_counted(trainer, group, syncs, inner_calls)
    torch.cuda.reset_peak_memory_stats(dev)
    group.barrier()
    dispatch.reset_launches()
    out = train_distributed.run_rank(group, args, trainer=trainer)
    torch.cuda.synchronize(dev)
    launches = dispatch.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    group.barrier()   # every rank holds its state: the card's use now
    free, total = torch.cuda.mem_get_info(dev)
    res, state = out["result"], out["result"]["state"]
    m = args.inner_steps
    inner = [dt * 1e3 for t, dt in enumerate(res["step_dt_s"]) if t and (t + 1) % m]
    total_ms, split = _outer_alone(trainer, group, state)
    syncs_in_run = syncs[:res["outer_syncs"]]
    row = {
        "rank": group.rank, "losses": res["losses"], "launches": launches,
        "inner_step_p50_ms": statistics.median(inner), "inner_step_p99_ms": _pct(inner, 0.99),
        "inner_step_samples": len(inner),
        "outer_step_alone_ms": statistics.median(total_ms),
        "outer_split_ms": {k: statistics.median(v) for k, v in split.items()},
        "sync_calls": [s["calls"] for s in syncs_in_run],
        "sync_bytes": [s["bytes"] for s in syncs_in_run],
        "payload_bytes": res["comm"]["payload_bytes"] if res["comm"] else 0,
        "comm_bytes": res["comm_bytes"], "outer_syncs": res["outer_syncs"],
        "inner_calls": inner_calls,
        "peak_memory_gb": peak_gb, "card_used_gb": (total - free) / 1e9,
        "card_total_gb": total / 1e9,
        "partners": [p.tolist() for p in trainer.partners[:res["outer_syncs"]]],
        "final_weight_std": res["final_weight_std"], "summary": out["summary"],
        "staged": group.staged,
    }
    del out, res, state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return row


def dist_small_run(group, argv, device, **kw):
    """A ``reduced()`` run on this rank; returns the loop's result and the
    trainer."""
    from repro_torch.launch import train_distributed

    sub = group if device == "cuda" else dataclasses.replace(
        group, device=torch.device("cpu"), calls=type(group.calls)(),
        sent_bytes=type(group.sent_bytes)(), _pinned={})
    args = _dist_args(argv, device, group.backend)
    for k, v in kw.items():
        setattr(args, k, v)
    out = train_distributed.run_rank(sub, args)
    return out["result"], out["trainer"]


def _dist_rows(state) -> dict:
    return {"theta": state["theta"], "phi": state["phi"], "delta": state["delta"],
            "mu": state["opt"].mu, "nu": state["opt"].nu}


def dist_rank(group, ckpt_root: str) -> dict:
    """Phases 44–47 on one rank: the full-width runs, fp32 card against
    CPU, and a resume on the card."""
    out = {"full": {name: dist_full_run(group, argv) for name, argv in DIST_RUNS}}
    # phase 45: fp32 reduced() on the card and on the CPU, same ranks
    dispatch.reset_launches()
    card, card_tr = dist_small_run(group, DIST_SMALL, "cuda")
    torch.cuda.synchronize(group.device)
    launches = dispatch.launch_counts()
    cpu, cpu_tr = dist_small_run(group, DIST_SMALL, "cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    out["parity"] = {
        "loss_max_rel_diff": rel,
        "partners_identical": [p.tolist() for p in card_tr.partners]
        == [p.tolist() for p in cpu_tr.partners] and len(card_tr.partners) == 2,
        "weight_std_rel_diff": abs(card["final_weight_std"] - cpu["final_weight_std"])
        / cpu["final_weight_std"],
        "launches": {k: launches[k] for k in TRAIN_KERNELS}}
    # phase 46: on the card, 5 steps saved, resumed to 10, against 10 straight
    whole = os.path.join(ckpt_root, "whole")
    half = os.path.join(ckpt_root, "half")
    a, _ = dist_small_run(group, DIST_SMALL + ["--codec", "int8"], "cuda", ckpt_dir=whole,
                          ckpt_every=DIST_MID)
    dist_small_run(group, DIST_SMALL + ["--codec", "int8"], "cuda", ckpt_dir=half,
                   steps=DIST_MID)
    t0 = time.perf_counter()
    b, _ = dist_small_run(group, DIST_SMALL + ["--codec", "int8"], "cuda", ckpt_dir=half,
                          resume=True)
    same = all(torch.equal(x, y) for k in ("theta", "phi", "delta", "mu", "nu")
               for x, y in zip(tree_leaves(_dist_rows(a["state"])[k]),
                               tree_leaves(_dist_rows(b["state"])[k])))
    out["resume"] = {"start_step": b["start_step"], "losses_identical": b["losses"] == a["losses"][DIST_MID:],
                     "bit_identical": bool(same), "resumed_run_s": time.perf_counter() - t0}
    return out


def dist_expected(cfg, name: str, syncs: int) -> dict[str, int]:
    """A rank's launches: phase 6's design for one replica (one forward and
    one backward per layer and step; NoLoCo: one update per leaf a sync;
    int8: one quantize and one dequantize per float buffer of (Δ, φ) a
    sync; DiLoCo's mean and update are eager: no kernel)."""
    codec = "int8" if name == "int8" else "none"
    want = expected_launches(cfg, {"steps": 10}, syncs, codec)
    if name == "diloco":
        want["noloco_update"] = 0
    return {k: want[k] for k in TRAIN_KERNELS + INT8}


def dist_phase(dev) -> tuple[dict, dict]:
    """Phases 44–48: paper-small-125m at full width on 4 ranks sharing the
    card over gloo, the payload staged through pinned host memory; NoLoCo
    on the plain and the int8 wire, DiLoCo; then fp32 card vs CPU, a resume
    on the card, the counted outer step; NCCL where the machine shows two
    cards or more; and the CLI itself."""
    from repro_torch.launch import mesh as mesh_lib

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dist_cfg()
    ckpt_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                             "chip_smoke_dist_ckpt")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    os.makedirs(ckpt_root)
    ranks = mesh_lib.spawn(dist_rank, DIST_WORLD, (ckpt_root,), backend="gloo", device="cuda")
    out, launches = {"card": card(), "world": DIST_WORLD, "backend": "gloo"}, {}
    for name, _ in DIST_RUNS:
        rows = [r["full"][name] for r in ranks]
        want = dist_expected(cfg, name, 2)
        for row in rows:
            got = {k: row["launches"][k] for k in want}
            if got != want:
                raise AssertionError(f"dist {name} rank {row['rank']}: launches {got} != {want}")
            if not all(math.isfinite(x) for x in row["losses"]) or not row["losses"][-1] < row["losses"][0]:
                raise AssertionError(f"dist {name} rank {row['rank']}: losses {row['losses']}")
            if name == "diloco":   # one all_reduce per buffer of the fused Δ (bf16, fp32),
                # each in its dtype: the byte model's ring bytes are 2(w-1)/w of them
                spec = payload.make_spec(bytes_model.abstract_params(cfg))
                ok = all(c == {"all_reduce": len(spec.buffers)} for c in row["sync_calls"])
                ok &= all(b == spec.nbytes for b in row["sync_bytes"])
                ok &= row["payload_bytes"] == round(spec.nbytes * 2 * (DIST_WORLD - 1) / DIST_WORLD)
            else:
                ok = all(c == {"p2p": 1} for c in row["sync_calls"])
                ok &= all(b == row["payload_bytes"] for b in row["sync_bytes"])
            if not ok or row["outer_syncs"] != 2 or any(row["inner_calls"].values()):
                raise AssertionError(f"dist {name} rank {row['rank']}: calls {row['sync_calls']} "
                                     f"bytes {row['sync_bytes']} inner {row['inner_calls']}")
        if len({json.dumps(r["partners"]) for r in rows}) != 1:
            raise AssertionError(f"dist {name}: ranks disagree on the partners")
        summary = rows[0]["summary"]
        launches[name] = {k: sum(r["launches"][k] for r in rows) for k in TRAIN_KERNELS + INT8}
        out[name] = {
            "summary": summary,
            "partners": rows[0]["partners"],
            "launches_per_rank": [{k: r["launches"][k] for k in want} for r in rows],
            "launches_design": want,
            "inner_step_p50_ms": [r["inner_step_p50_ms"] for r in rows],
            "inner_step_p99_ms": [r["inner_step_p99_ms"] for r in rows],
            "outer_step_alone_ms": [r["outer_step_alone_ms"] for r in rows],
            "outer_split_ms": [r["outer_split_ms"] for r in rows],
            "sync_calls": rows[0]["sync_calls"], "sync_bytes": rows[0]["sync_bytes"],
            "payload_bytes": rows[0]["payload_bytes"],
            "peak_memory_gb": [r["peak_memory_gb"] for r in rows],
            "card_used_gb": max(r["card_used_gb"] for r in rows),
            "card_total_gb": rows[0]["card_total_gb"],
            "loss_first_last": [[r["losses"][0], r["losses"][-1]] for r in rows],
            "final_weight_std": rows[0]["final_weight_std"],
        }
        log(f"dist {name} (4 ranks, gloo, staged={rows[0]['staged']}): " + json.dumps(out[name]))
    for r in ranks:
        par = r["parity"]
        if not (par["partners_identical"] and par["loss_max_rel_diff"] <= LOSS_RTOL
                and par["weight_std_rel_diff"] <= WSTD_RTOL and min(par["launches"].values()) > 0):
            raise AssertionError(f"dist fp32 card vs cpu: {par}")
        res = r["resume"]
        if not (res["start_step"] == DIST_MID and res["losses_identical"] and res["bit_identical"]):
            raise AssertionError(f"dist resume on card: {res}")
    out["card_vs_cpu"] = [r["parity"] for r in ranks]
    out["resume"] = [r["resume"] for r in ranks]
    log("dist fp32 card vs cpu (4 ranks): " + json.dumps(out["card_vs_cpu"]))
    log("dist resume on card (int8 wire): " + json.dumps(out["resume"]))
    out["one_rank_a_card"] = dist_cards_phase()
    # the CLI through its own entry point, on the card
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_distributed", *DIST_SMALL[:-4],
         "--steps", "4", "--inner-steps", "2"],
        capture_output=True, text=True, cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                     "src")), timeout=300)
    if cli.returncode != 0:
        raise AssertionError(f"train_distributed CLI failed:\n{cli.stdout}\n{cli.stderr}")
    out["cli"] = json.loads(cli.stdout.strip().splitlines()[-1])
    if out["cli"]["device"] != torch.cuda.get_device_name(0) or out["cli"]["backend"] != "gloo":
        raise AssertionError(f"CLI summary: {out['cli']}")
    log("dist CLI: " + json.dumps(out["cli"]))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"dist phases: {out['seconds']:.1f} s")
    return out, launches


def dist_card_rank(group) -> dict:
    """Phase 48's rank: the plain full-width run, one card each."""
    row = dist_full_run(group, DIST_RUNS[0][1])
    return {k: row[k] for k in ("rank", "inner_step_p50_ms", "inner_step_p99_ms",
                                "outer_step_alone_ms", "outer_split_ms", "sync_calls",
                                "sync_bytes", "payload_bytes", "peak_memory_gb", "staged")}


def dist_card_stream_rank(group) -> dict:
    """Phase 48's streamed rank: phase 51's plain streamed run, one card
    each, each sync split by the clock."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_dist_nccl")
    os.makedirs(root, exist_ok=True)
    run = dist_plan_run(group, root, "stream-nccl", DIST_WIDTH + DIST_STREAM, None, clock=True)
    syncs = run["probe"].syncs
    return {"rank": group.rank, "staged": group.staged,
            "checks": _stream_checks(dist_cfg(), run, "none"),
            "inner_ms": run["probe"].inner_ms(),
            "consuming": _summary_ms([s for s in syncs if not s["event"]["blocked"] and s["bytes"]]),
            "blocking": _summary_ms([s for s in syncs if s["event"]["blocked"] and s["bytes"]])}


def dist_cards_phase() -> dict:
    """Phase 48, where the machine shows two cards or more: the plain
    full-width run with one rank a card, over NCCL (card to card) and over
    gloo (staged through pinned host memory), each rank's row; otherwise a
    line that says why it did not run.  Alone on a machine with several
    cards: ``python3 -c "import chip_smoke; chip_smoke.dist_cards_phase()"``."""
    from repro_torch.launch import mesh as mesh_lib

    cards = torch.cuda.device_count()
    if cards < 2:
        out = f"not run: NCCL puts one rank on each card and this machine shows {cards}"
        log("dist one rank a card: " + out)
        log(f"dist nccl streamed: not run: phase 51's streamed run over NCCL takes {DIST_WORLD} "
            f"cards and this machine shows {cards}")
        log(f"dist-tp nccl: not run: phase 53's run over NCCL takes 2 cards (--data 1 --model 2) "
            f"and this machine shows {cards}")
        return out
    world = min(DIST_WORLD, cards)
    out = {"cards": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines(), "world": world}
    log(f"dist one rank a card on {world} of: " + json.dumps(out["cards"]))
    if cards >= DIST_WORLD:   # phase 51's plain streamed run, one rank a card, over NCCL
        rows = mesh_lib.spawn(dist_card_stream_rank, world, (), backend="nccl", device="cuda")
        for row in rows:
            if not all(row["checks"].values()):
                raise AssertionError(f"dist nccl streamed, one rank a card: {row}")
        out["nccl_stream"] = rows
        log(f"dist nccl streamed ({world} ranks, one card each): " + json.dumps(rows))
    else:
        out["nccl_stream"] = (f"not run: phase 51's streamed run over NCCL takes {DIST_WORLD} "
                              f"cards and this machine shows {cards}")
        log("dist nccl streamed: " + out["nccl_stream"])
    for backend in ("nccl", "gloo"):
        rows = mesh_lib.spawn(dist_card_rank, world, (), backend=backend, device="cuda")
        for row in rows:
            if not (all(c == {"p2p": 1} for c in row["sync_calls"])
                    and all(b == row["payload_bytes"] for b in row["sync_bytes"])
                    and row["staged"] == (backend == "gloo")):
                raise AssertionError(f"dist {backend} one rank a card: {row}")
        out[backend] = rows
        log(f"dist {backend} ({world} ranks, one card each): " + json.dumps(rows))
    # phase 53's plain run over NCCL, one rank a card: --data 1 --model 2 on
    # 2 cards, 2 × 2 on 4; the model axis's calls and its all-reduce's ms
    tp_world = 4 if cards >= 4 else 2
    rows = mesh_lib.spawn(dist_tp_card_rank, tp_world, (tp_world // 2,), backend="nccl",
                          device="cuda", tp=2)
    for row in rows:
        if row["staged"] or any(c != row["model_calls_design"] for c in row["model_calls_per_step"]):
            raise AssertionError(f"dist-tp nccl one rank a card: {row}")
    out["nccl_tp"] = rows
    log(f"dist-tp nccl ({tp_world // 2} × 2 ranks, one card each): " + json.dumps(rows))
    return out


# ---------------------------------------------------------------------------
# Phases 49–52: elastic, asynchronous and streamed rounds on the replica group
# ---------------------------------------------------------------------------

# phase 49: paper-small-125m at full width in bf16, 4 × 1024 a rank, m 5, 35
# steps (7 rounds) through the elastic plan
DIST_EL_PLAN = [{"kind": "drop", "round": 1, "replicas": [3]},
                {"kind": "rejoin", "round": 3, "replicas": [3], "source": 0},
                {"kind": "straggle", "round": 4, "replicas": [1], "rounds": 1},
                {"kind": "partition", "round": 5, "groups": [[0, 1], [2, 3]]},
                {"kind": "heal", "round": 6}]
DIST_EL = ["--steps", "35", "--inner-steps", "5"]
# phase 50: the 2× straggler, its stale Δ discounted; a rate-1 world against
# the synchronous run of DIST_RATE1 steps (reduced(), in fp32)
DIST_ASYNC_PLAN = [{"kind": "rate", "round": 0, "replicas": [1], "rate": 0.5}]
DIST_RATE1_PLAN = [{"kind": "rate", "round": 0, "replicas": [1], "rate": 1.0}]
DIST_ASYNC = ["--steps", "24", "--inner-steps", "4", "--stale", "momentum"]
DIST_RATE1 = ["--steps", "8", "--inner-steps", "4", "--stale", "momentum"]
# phase 51: phase 33's schedule (m 5, 15 steps, 4 streams with the overlap)
# and tests/test_streaming.py's churn (m 4, 28 steps, rank 3 out over 9–17)
DIST_STREAM = ["--steps", "15", "--inner-steps", "5", "--stream-count", str(STREAMS)]
DIST_CHURN_PLAN = [{"kind": "drop", "step": 9, "replicas": [3]},
                   {"kind": "rejoin", "step": 17, "replicas": [3]}]
DIST_CHURN = ["--steps", "28", "--inner-steps", "4", "--stream-count", str(STREAMS)]
DIST_WIDTH = ["--data", str(DIST_WORLD), "--batch-per-replica", "4", "--seq", "1024",
              "--pairing-pool", "16"]
# phase 52: the same plans on reduced() in fp32, and the resumes
DIST_SMALL_WIDTH = ["--data", str(DIST_WORLD), "--reduced", "--batch-per-replica", "2",
                    "--seq", "64", "--pairing-pool", "16"]
DIST_ASYNC_MID, DIST_STREAM_MID = 13, 11
BLOCKING = ("encode", "d2h", "wire", "h2d", "decode")
PRESEND_WAIT = ("pre_wire", "pre_h2d", "pre_decode")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launch_counts(dev) -> dict:
    return dispatch.launch_counts() if dev.type == "cuda" else {}


def _minus(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def dist_rows(state) -> dict:
    """This rank's checksum of every leaf of θ, φ, δ and both moments, and
    its step count."""
    out = {k: [bits_checksum(x[0]) for x in tree_leaves(t)]
           for k, t in _dist_rows(state).items()}
    out["count"] = int(state["opt"].count[0])
    return out


class DistProbe:
    """On one rank, while entered: each inner step's launches, cross-rank
    calls, time and whether the rank stepped; each sync's launches, calls,
    bytes by kind, time and (``clock``) its phases on a synchronising
    :class:`~repro_torch.launch.mesh.PhaseClock`; the warm start's calls,
    bytes and time, and the rows around it: ``rows["at_drop"]`` when the
    rank first sits a step out of the membership, ``rows["before_rejoin"]``
    and ``rows["after_rejoin"]`` around its warm start, ``rows["source"]``
    (φ alone) on the source."""

    def __init__(self, trainer, group, clock: bool = False):
        self.tr, self.group, self.clock = trainer, group, clock
        self.steps, self.syncs, self.warm, self.rows = [], [], [], {}

    def __enter__(self):
        from repro_torch.launch import mesh as mesh_lib

        tr, group, dev, probe = self.tr, self.group, self.group.device, self
        inner, outer, outer_async, warm = (tr.inner_step, tr.maybe_outer_step,
                                           tr.outer_step_async, tr.warm_start)

        def spy_inner(state, batch):
            active = tr.active()
            if not tr.member() and "at_drop" not in probe.rows:
                probe.rows["at_drop"] = dist_rows(state)
            launches, calls = _launch_counts(dev), dict(group.calls)
            _sync(dev)
            t0 = time.perf_counter()
            out = inner(state, batch)
            _sync(dev)
            probe.steps.append({"active": active, "ms": (time.perf_counter() - t0) * 1e3,
                                "launches": _minus(_launch_counts(dev), launches),
                                "calls": _minus(dict(group.calls), calls)})
            return out

        def spy_outer(fn):
            def run(state, **kw):
                launches, calls, sent = _launch_counts(dev), dict(group.calls), dict(group.sent_bytes)
                events = len(tr.stream_events)
                clock = mesh_lib.PhaseClock(dev) if probe.clock else None
                _sync(dev)
                group.clock = clock
                t0 = time.perf_counter()
                if clock is not None:
                    clock.start()
                state, synced = fn(state, **kw)
                if clock is not None:
                    clock.mark("update")
                group.clock = None
                _sync(dev)
                if synced:
                    probe.syncs.append({
                        "ms": (time.perf_counter() - t0) * 1e3,
                        "phases": {} if clock is None else dict(clock.ms),
                        "launches": _minus(_launch_counts(dev), launches),
                        "calls": _minus(dict(group.calls), calls),
                        "bytes": _minus(dict(group.sent_bytes), sent),
                        "event": dict(tr.stream_events[-1]) if len(tr.stream_events) > events
                        else None,
                        "partner": tr.partners[-1].tolist() if tr.partners else None,
                        "pre_partner": tr.pre_partner(tr.stream_events[-1]["stream"]).tolist()
                        if len(tr.stream_events) > events and tr.comm_cfg.overlap else None})
                return state, synced
            return run

        def spy_warm(state, replica, source):
            if tr.replica == replica:
                probe.rows["before_rejoin"] = dist_rows(state)
            if tr.replica == source:
                probe.rows["source"] = [bits_checksum(x[0]) for x in tree_leaves(state["phi"])]
            calls, sent = dict(group.calls), dict(group.sent_bytes)
            _sync(dev)
            t0 = time.perf_counter()
            new = warm(state, replica, source)
            _sync(dev)
            probe.warm.append({"ms": (time.perf_counter() - t0) * 1e3,
                               "calls": _minus(dict(group.calls), calls),
                               "bytes": _minus(dict(group.sent_bytes), sent)})
            if tr.replica == replica:
                probe.rows["after_rejoin"] = dist_rows(new)
            return new

        tr.inner_step, tr.maybe_outer_step = spy_inner, spy_outer(outer)
        tr.outer_step_async, tr.warm_start = spy_outer(outer_async), spy_warm
        self._real = (inner, outer, outer_async, warm)
        return self

    def __exit__(self, *exc):
        (self.tr.inner_step, self.tr.maybe_outer_step, self.tr.outer_step_async,
         self.tr.warm_start) = self._real

    def inner_ms(self) -> dict:
        """Inner-step p50 / p99 ms over the steps this rank took (its first
        step, the warm-up, left out)."""
        ms = sorted(s["ms"] for s in self.steps[1:] if s["active"])
        return {"p50": statistics.median(ms), "p99": _pct(ms, 0.99), "n": len(ms)} if ms else {}


def _dist_plan_file(root: str, name: str, events: list, rank: int) -> str:
    path = os.path.join(root, f"plan-{name}-{rank}.json")
    with open(path, "w") as f:
        json.dump({"events": events}, f)
    return path


_INITIAL: dict = {}
_RUN_SECONDS: list = []   # (run, seconds in all, the loop's wall seconds) of this rank's runs


def dist_trainer(args, group):
    """The CLI's trainer for ``args`` on ``group``; on the card its initial
    weights are drawn on the host once per config and seed in this process
    and copied to the card by each run (a full-width draw takes seconds)."""
    from repro_torch.launch import train_distributed

    trainer = train_distributed.make_trainer(args, group, None if args.reduced else dist_cfg())
    if group.device.type == "cuda":
        key = (trainer.cfg, trainer.seed)
        if key not in _INITIAL:
            _INITIAL[key] = trainer.initial_params()
        trainer.initial_params = lambda: _INITIAL[key]
    return trainer


def dist_plan_run(group, root: str, name: str, argv: list, events, *, device=None,
                  clock: bool = False, **kw) -> dict:
    """One run of the CLI's rank body on this rank (``device``: ``"cpu"``
    runs the same ranks on the CPU) under the plan ``events`` (None: no
    plan), probed; the loop's result, the rounds, the probe and the launch
    counts of the run."""
    from repro_torch.launch import train_distributed

    device = device or group.device.type
    sub = group if device == group.device.type else dataclasses.replace(
        group, device=torch.device(device), calls=type(group.calls)(),
        sent_bytes=type(group.sent_bytes)(), _pinned={})
    argv = list(argv)
    if events is not None:
        argv += ["--fault-plan", _dist_plan_file(root, name, events, group.rank)]
    args = _dist_args(argv, device, group.backend)
    for k, v in kw.items():
        setattr(args, k, v)
    t0 = time.perf_counter()
    trainer = dist_trainer(args, sub)
    dev = sub.device
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    group.barrier()
    dispatch.reset_launches()
    with DistProbe(trainer, sub, clock=clock) as probe:
        out = train_distributed.run_rank(sub, args, trainer=trainer)
    _sync(dev)
    launches = _launch_counts(dev)
    res = out["result"]
    _RUN_SECONDS.append((name, time.perf_counter() - t0, res["wall_s"]))
    return {"res": res, "trainer": trainer, "probe": probe, "launches": launches,
            "rounds": None if out["sim"] is None else out["sim"].rounds(),
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0,
            "summary": out["summary"]}


def _dist_step_design(cfg) -> dict:
    """One inner step's launches on one rank: the flash pair per layer."""
    one = expected_launches(cfg, {"steps": 1}, 0)
    return {k: one[k] for k in ("flash_attention", "flash_attention_bwd")}


def _check_launches(cfg, run: dict, takes_part) -> bool:
    """Every step this rank took launched the design's flash pair and every
    step it sat out launched nothing; each sync launched one update per
    leaf when the rank took part in its round (``takes_part(record)``),
    else none."""
    step = _dist_step_design(cfg)
    leaves = len(tree_leaves(bytes_model.abstract_params(cfg)))
    ok = all(s["launches"] == (step if s["active"] else {}) for s in run["probe"].steps)
    ok &= len(run["probe"].syncs) == len(run["rounds"])
    for sync, rec in zip(run["probe"].syncs, run["rounds"]):
        ok &= sync["launches"].get("noloco_update", 0) == (leaves if takes_part(rec) else 0)
    return ok


def _summary_ms(syncs: list[dict], phases=DIST_PHASES + ("pre_encode", "pre_d2h", "pre_post")
                + PRESEND_WAIT) -> dict:
    """Median ms of each sync phase over ``syncs`` and of the whole sync,
    with the blocking exchange (encode, D2H, wire, H2D, decode) and the
    wait on the pre-send (its wire, H2D, decode) summed."""
    if not syncs:
        return {}
    med = lambda xs: statistics.median(xs)
    out = {"n": len(syncs), "ms": med([s["ms"] for s in syncs])}
    for p in phases:
        out[p] = med([s["phases"].get(p, 0.0) for s in syncs])
    out["blocking_exchange_ms"] = med([sum(s["phases"].get(p, 0.0) for p in BLOCKING)
                                       for s in syncs])
    out["presend_wait_ms"] = med([sum(s["phases"].get(p, 0.0) for p in PRESEND_WAIT)
                                  for s in syncs])
    return out


def dist_elastic_run(group, root: str) -> dict:
    """Phase 49 on this rank."""
    cfg = dist_cfg()
    run = dist_plan_run(group, root, "elastic", DIST_WIDTH + DIST_EL, DIST_EL_PLAN)
    res, probe, rounds = run["res"], run["probe"], run["rounds"]
    r = group.rank
    losses = [x for x in res["losses"] if not math.isnan(x)]
    return {
        "rank": r, "rounds": _compact(rounds), "launches": run["launches"],
        "launches_as_designed": _check_launches(
            cfg, run, lambda rec: r in rec["active"] and r not in rec["absent"]),
        "sat_out_steps": sum(not s["active"] for s in probe.steps),
        "inner_calls": sum(sum(s["calls"].values()) for s in probe.steps),
        "sync_calls": [s["calls"] for s in probe.syncs],
        "warm": probe.warm, "rows": probe.rows,
        "losses_finite": bool(losses) and all(map(math.isfinite, losses)),
        "loss_first_last": [losses[0], losses[-1]],
        "inner_ms": probe.inner_ms(), "outer_ms": [s["ms"] for s in probe.syncs],
        "peak_gb": run["peak_gb"], "summary": run["summary"],
    }


def dist_async_run(group, root: str) -> dict:
    """Phase 50 on this rank: the 2× straggler, then a rate-1 world against
    the synchronous run."""
    cfg = dist_cfg()
    run = dist_plan_run(group, root, "async", DIST_WIDTH + DIST_ASYNC, DIST_ASYNC_PLAN)
    res, probe, rounds = run["res"], run["probe"], run["rounds"]
    r = group.rank
    out = {
        "rank": r, "rounds": _compact(rounds), "launches": run["launches"],
        "launches_as_designed": _check_launches(cfg, run, lambda rec: r in rec["due"]),
        "max_staleness": res["max_staleness"], "blocked_syncs": res["blocked_syncs"],
        "sat_out_steps": sum(not s["active"] for s in probe.steps),
        "sync_calls": [s["calls"] for s in probe.syncs],
        "losses_finite": all(math.isfinite(x) for x in res["losses"] if not math.isnan(x)),
        "inner_ms": probe.inner_ms(), "tick_ms": [s["ms"] for s in probe.syncs],
        "peak_gb": run["peak_gb"],
    }
    del run, res
    plain = dist_plan_run(group, root, "sync", DIST_SMALL_WIDTH + DIST_RATE1, None)
    rate1 = dist_plan_run(group, root, "rate1", DIST_SMALL_WIDTH + DIST_RATE1, DIST_RATE1_PLAN)
    out["rate1_vs_sync"] = {
        "losses_identical": rate1["res"]["losses"] == plain["res"]["losses"],
        "rows_identical": dist_rows(rate1["res"]["state"]) == dist_rows(plain["res"]["state"]),
        "max_staleness": rate1["res"]["max_staleness"]}
    return out


def _stream_checks(cfg, run: dict, codec: str) -> dict:
    """A streamed run's syncs on this rank: each stream's first blocks and
    the later ones consume (a healthy run); the blocking part and the
    pre-send of a paired rank move the byte model's bytes (the fused
    (Δ_k, φ_k) pair when blocking; a rank paired with itself moves none)
    and no sync all-reduces; launches as designed: the flash pair in each
    step the rank took and nothing in one it sat out, one update per leaf
    of the stream when the rank takes part, and on the int8 wire one
    quantize per buffer it encodes (the sync's, when it takes part or is
    paired, and the pre-send's) and one dequantize per buffer it decodes
    (the sync's, and the pre-send that the stream's last sync posted and
    this one waits)."""
    r = run["trainer"].replica
    per = run["trainer"].stream_cost().per_stream
    _, subs = _stream_subs(cfg)
    rounds = {rec["round"]: rec for rec in run["rounds"] or []}
    seen, ok_order, ok_bytes, ok_launch = set(), True, True, True
    posted = set()   # streams with a pre-send in flight: decoded when their next sync waits it
    buffers = lambda tree: len(payload.make_spec(tree).buffers)
    for sync in run["probe"].syncs:
        ev = sync["event"]
        k, sub = ev["stream"], subs[ev["stream"]]
        if not rounds:
            ok_order &= ev["blocked"] == (k not in seen) and not ev["epoch_fallback"]
        seen.add(k)
        rec = rounds.get(ev["sync_index"])
        takes_part = rec is None or (r in rec["active"] and r not in rec["absent"])
        paired = sync["partner"][r] != r
        blocking = per[k].payload_bytes if ev["blocked"] else per[k].blocking_bytes
        if codec != "none" and ev["blocked"]:
            blocking = bytes_model.spec_cost(payload.make_spec((sub, sub)),
                                             CommConfig(codec=codec))[0]
        ok_bytes &= sync["bytes"].get("p2p", 0) == (blocking if paired else 0)
        ok_bytes &= sync["bytes"].get("presend", 0) == (
            per[k].payload_bytes - per[k].blocking_bytes if sync["pre_partner"][r] != r else 0)
        ok_bytes &= "all_reduce" not in sync["calls"]
        want = {"noloco_update": len(sub) if takes_part else 0}
        if codec == "int8":
            moved = buffers((sub, sub) if ev["blocked"] else sub) if takes_part or paired else 0
            want.update(int8_quantize=moved + buffers(sub),
                        int8_dequantize=moved + (buffers(sub) if k in posted else 0))
        ok_launch &= all(sync["launches"].get(name, 0) == n for name, n in want.items())
        posted.add(k)
    step = _dist_step_design(cfg)
    ok_launch &= all(s["launches"] == (step if s["active"] else {}) for s in run["probe"].steps)
    return {"first_blocks_later_consume": ok_order, "bytes_as_byte_model": ok_bytes,
            "launches_as_designed": ok_launch}


def time_dist_stream_cycle(group, root: str, state, codec: str, reps: int = 3) -> dict:
    """On one state and one wire: phase 44's full outer step alone (a
    trainer without streams), then cycles of four stream syncs on a
    streamed trainer, the first cycle blocking and pre-sending, the later
    ones consuming; each sync split by a synchronising clock."""
    from repro_torch.launch import train_distributed

    dev = group.device
    out = {}
    for name, extra in (("full", []), ("streams", ["--stream-count", str(STREAMS)])):
        args = _dist_args(DIST_WIDTH + ["--steps", "15", "--inner-steps", "5", "--codec", codec]
                          + extra, dev.type, group.backend)
        tr = dist_trainer(args, group)
        tr.init_state(None)
        st = dict(state, inner_step=15, outer_step=0)
        if name == "streams":
            st["phi_pre"] = tree_map(torch.clone, state["phi"])
        syncs = []
        with DistProbe(tr, group, clock=True) as probe:
            for rep in range(reps):
                for k in range(1 if name == "full" else STREAMS):
                    t = 20 + 5 * rep + (k * 5) // STREAMS
                    group.barrier()
                    new, _ = tr.maybe_outer_step(dict(st, inner_step=t))
                    if name == "streams":
                        st = dict(st, phi=new["phi"], delta=new["delta"], theta=new["theta"],
                                  phi_pre=new.get("phi_pre"), outer_step=new["outer_step"])
                    del new
            st = tr.finish(st)
            syncs = probe.syncs
        del tr, st
        if name == "full":
            out["full_outer_step"] = _summary_ms(syncs)
        else:
            cycles = [sum(s["ms"] for s in syncs[i:i + STREAMS])
                      for i in range(0, len(syncs), STREAMS)]
            out["cycle_ms_blocking"] = cycles[0]
            out["cycle_ms_consuming"] = statistics.median(cycles[1:])
            out["sync_by_stream"] = {k: _summary_ms(syncs[k::STREAMS][1:]) for k in range(STREAMS)}
    return out


def dist_stream_run(group, root: str) -> dict:
    """Phase 51 on this rank: 4 streams on the plain and the int8 wire, each
    sync split by the clock, a cycle against the full outer step; then the
    streamed churn."""
    cfg = dist_cfg()
    out = {"rank": group.rank}
    for codec in ("none", "int8"):
        run = dist_plan_run(group, root, f"stream-{codec}",
                            DIST_WIDTH + DIST_STREAM + ["--codec", codec], None, clock=True)
        probe = run["probe"]
        checks = _stream_checks(cfg, run, codec)
        losses = run["res"]["losses"]
        consuming = [s for s in probe.syncs if not s["event"]["blocked"] and s["bytes"]]
        blocking = [s for s in probe.syncs if s["event"]["blocked"] and s["bytes"]]
        row = {"checks": checks, "launches": run["launches"],
               "events": [{k: s["event"][k] for k in ("stream", "sync_index", "blocked",
                                                      "payload_bytes", "blocking_bytes")}
                          for s in probe.syncs],
               "losses_finite_falling": all(map(math.isfinite, losses)) and losses[-1] < losses[0],
               "inner_ms": probe.inner_ms(), "consuming": _summary_ms(consuming),
               "blocking": _summary_ms(blocking), "peak_gb": run["peak_gb"],
               "blocking_fraction": run["res"]["blocking_fraction"],
               "warm_presend_wait_ms_in_run": [sum(s["phases"].get(p, 0.0) for p in PRESEND_WAIT)
                                               for s in probe.syncs]}
        state = run["trainer"].finish(run["res"]["state"])
        del run
        row.update(time_dist_stream_cycle(group, root, state, codec))
        del state
        out[codec] = row
    churn = dist_plan_run(group, root, "stream-churn", DIST_WIDTH + DIST_CHURN, DIST_CHURN_PLAN)
    events = [s["event"] for s in churn["probe"].syncs]
    epochs = {}
    for rec, ev in zip(churn["rounds"], events):
        key = (tuple(rec["active"]), ev["stream"])
        epochs[key] = epochs.get(key, 0) + ev["epoch_fallback"]
    out["churn"] = {"launches": churn["launches"],
                    "fallbacks": sum(ev["epoch_fallback"] for ev in events),
                    "at_most_one_per_stream_per_change": max(epochs.values()) <= 1,
                    "checks": _stream_checks(cfg, churn, "none"),
                    "losses_finite": all(math.isfinite(x) for x in churn["res"]["losses"]
                                         if not math.isnan(x))}
    return out


def _small_compare(card: dict, cpu: dict) -> dict:
    lc = np.asarray(card["res"]["losses"], dtype=np.float64)
    lp = np.asarray(cpu["res"]["losses"], dtype=np.float64)
    same_nan = bool(np.array_equal(np.isnan(lc), np.isnan(lp)))
    keep = ~np.isnan(lp)
    ev = lambda run: [s["event"] for s in run["probe"].syncs]
    return {
        "rounds_identical": card["rounds"] == cpu["rounds"],
        "partners_identical": [p.tolist() for p in card["trainer"].partners]
        == [p.tolist() for p in cpu["trainer"].partners],
        "stream_events_identical": ev(card) == ev(cpu),
        "loss_max_rel_diff": float(np.max(np.abs(lc[keep] - lp[keep]) / np.abs(lp[keep])))
        if same_nan else float("inf"),
        "weight_std_rel_diff": abs(card["res"]["final_weight_std"] - cpu["res"]["final_weight_std"])
        / max(cpu["res"]["final_weight_std"], 1e-30),
    }


def dist_parity_run(group, root: str) -> dict:
    """Phase 52 on this rank: reduced() in fp32, the plans of 49, 50 and 51's
    churn on the card and on the CPU; then on the card a resume mid-straggle
    and one mid-stream, each against the card's uninterrupted run of its
    plan above."""
    out, whole = {"rank": group.rank}, {}
    for name, argv, events in (("elastic", DIST_EL, DIST_EL_PLAN),
                               ("async", DIST_ASYNC, DIST_ASYNC_PLAN),
                               ("stream_churn", DIST_CHURN, DIST_CHURN_PLAN)):
        card = dist_plan_run(group, root, f"small-{name}", DIST_SMALL_WIDTH + argv, events)
        cpu = dist_plan_run(group, root, f"small-{name}-cpu", DIST_SMALL_WIDTH + argv, events,
                            device="cpu")
        out[name] = _small_compare(card, cpu)
        whole[name] = {"losses": card["res"]["losses"], "rows": dist_rows(card["res"]["state"])}
        del card, cpu
    for name, argv, events, mid in (("async", DIST_ASYNC, DIST_ASYNC_PLAN, DIST_ASYNC_MID),
                                    ("stream", DIST_CHURN, DIST_CHURN_PLAN, DIST_STREAM_MID)):
        ckpt = os.path.join(root, f"resume-{name}")
        dist_plan_run(group, root, f"half-{name}", DIST_SMALL_WIDTH + argv, events,
                      ckpt_dir=ckpt, steps=mid)
        resumed = dist_plan_run(group, root, f"resumed-{name}", DIST_SMALL_WIDTH + argv, events,
                                ckpt_dir=ckpt, resume=True)
        w, r = whole["stream_churn" if name == "stream" else name], resumed["res"]
        out[f"resume_{name}"] = {
            "start_step": r["start_step"],
            "losses_identical": np.array_equal(np.asarray(r["losses"]),
                                               np.asarray(w["losses"][mid:]), equal_nan=True),
            "bit_identical": dist_rows(r["state"]) == w["rows"]}
    return out


def dist_elastic_rank(group, root: str) -> dict:
    """Phases 49–52 on one rank (one spawn)."""
    out = {}
    for name, fn in (("elastic", dist_elastic_run), ("async", dist_async_run),
                     ("stream", dist_stream_run), ("parity", dist_parity_run)):
        t0 = time.perf_counter()
        out[name] = fn(group, root)
        out[name]["seconds"] = time.perf_counter() - t0
        out[name]["runs_s"], _RUN_SECONDS[:] = list(_RUN_SECONDS), []
        gc.collect()
        if group.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def dist_elastic_phase(dev) -> tuple[dict, dict]:
    """Phases 49–52: elastic, asynchronous and streamed rounds on 4 ranks
    sharing the card over gloo (one spawn): paper-small-125m at full width
    through the elastic plan (49), the 2× straggler (50), 4 streams with
    the non-blocking φ′ pre-send on the plain and the int8 wire and the
    streamed churn (51); then reduced() in fp32, card against CPU, and
    resumes mid-straggle and mid-stream (52)."""
    from repro_torch.launch import mesh as mesh_lib

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_dist_elastic")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ranks = mesh_lib.spawn(dist_elastic_rank, DIST_WORLD, (root,), backend="gloo", device="cuda")
    out, launches = dist_elastic_checks(ranks)
    shutil.rmtree(root, ignore_errors=True)
    out["card"] = card()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"dist elastic phases 49–52: {out['seconds']:.1f} s")
    return out, launches


def dist_elastic_checks(ranks: list[dict]) -> tuple[dict, dict]:
    """Phases 49–52's checks over the ranks' results; raises on the first
    phase that fails.  Returns the phases' records and every rank's
    launches of 49–51 by phase."""
    out = {"world": DIST_WORLD, "backend": "gloo"}
    launches = {}

    # phase 49
    el = [r["elastic"] for r in ranks]
    rounds = el[0]["rounds"]
    rows3, rows0 = el[3]["rows"], el[0]["rows"]
    zero = lambda rows, k: all(c == 0 for c in rows[k])
    checks = {
        "ranks_agree_on_rounds": all(r["rounds"] == rounds for r in el),
        "rounds_as_planned": len(rounds) == 7 and rounds[0]["active"] == [0, 1, 2, 3]
        and all(rec["active"] == [0, 1, 2] and rec["partner"][3] == 3 for rec in rounds[1:3])
        and rounds[3]["active"] == [0, 1, 2, 3] and rounds[4]["absent"] == [1]
        and rounds[4]["partner"][1] == 1 and rounds[5]["partition"] == [[0, 1], [2, 3]]
        and all(p // 2 == i // 2 for i, p in enumerate(rounds[5]["partner"]))
        and rounds[6]["partition"] is None,
        "rank3_rows_frozen_from_drop_to_rejoin": rows3.get("at_drop") is not None
        and rows3["at_drop"] == rows3.get("before_rejoin"),
        "rejoined_theta_phi_are_the_source_phi": rows3["after_rejoin"]["theta"]
        == rows3["after_rejoin"]["phi"] == rows0["source"]
        and all(zero(rows3["after_rejoin"], k) for k in ("delta", "mu", "nu"))
        and rows3["after_rejoin"]["count"] == 0,
        "warm_start_one_send": [r["warm"][0]["calls"] for r in el]
        == [{"send": 1}, {}, {}, {"recv": 1}],
        "sat_out_steps": [r["sat_out_steps"] for r in el] == [0, 0, 0, 10],
        "launches_as_designed": all(r["launches_as_designed"] for r in el),
        "no_call_in_inner_steps": all(r["inner_calls"] == 0 for r in el),
        "syncs_p2p_only": all(set(c) <= {"p2p"} for r in el for c in r["sync_calls"]),
        "losses_finite": all(r["losses_finite"] for r in el),
    }
    out["elastic"] = {
        "rounds": rounds, "checks": checks,
        "inner_ms": [r["inner_ms"] for r in el], "outer_ms": [r["outer_ms"] for r in el],
        "warm_start": [{k: r["warm"][0][k] for k in ("ms", "bytes")} for r in el],
        "peak_gb": [r["peak_gb"] for r in el], "loss_first_last": [r["loss_first_last"] for r in el],
        "summary": el[0]["summary"], "seconds": max(r["seconds"] for r in el)}
    log("dist elastic (phase 49): " + json.dumps(out["elastic"]))
    if not all(checks.values()):
        raise AssertionError(f"dist elastic failed its checks: {checks}")
    launches["elastic"] = {k: sum(r["launches"].get(k, 0) for r in el) for k in TRAIN_KERNELS + INT8}

    # phase 50
    asy = [r["async"] for r in ranks]
    checks = {
        "ranks_agree_on_rounds": all(r["rounds"] == asy[0]["rounds"] for r in asy),
        "max_staleness_1_blocked_0": all((r["max_staleness"], r["blocked_syncs"]) == (1, 0)
                                         for r in asy),
        "straggler_sits_half_out": [r["sat_out_steps"] for r in asy] == [0, 12, 0, 0],
        "launches_as_designed": all(r["launches_as_designed"] for r in asy),
        "syncs_p2p_only": all(set(c) <= {"p2p"} for r in asy for c in r["sync_calls"]),
        "losses_finite": all(r["losses_finite"] for r in asy),
        "rate1_bit_identical": all(r["rate1_vs_sync"]["losses_identical"]
                                   and r["rate1_vs_sync"]["rows_identical"]
                                   and r["rate1_vs_sync"]["max_staleness"] == 0 for r in asy),
    }
    out["async"] = {"rounds": asy[0]["rounds"], "checks": checks,
                    "inner_ms": [r["inner_ms"] for r in asy], "tick_ms": [r["tick_ms"] for r in asy],
                    "peak_gb": [r["peak_gb"] for r in asy], "seconds": max(r["seconds"] for r in asy)}
    log("dist async (phase 50): " + json.dumps(out["async"]))
    if not all(checks.values()):
        raise AssertionError(f"dist async failed its checks: {checks}")
    launches["async"] = {k: sum(r["launches"].get(k, 0) for r in asy) for k in TRAIN_KERNELS + INT8}

    # phase 51
    st = [r["stream"] for r in ranks]
    checks = {}
    for codec in ("none", "int8"):
        for name in ("first_blocks_later_consume", "bytes_as_byte_model", "launches_as_designed"):
            checks[f"{codec}_{name}"] = all(r[codec]["checks"][name] for r in st)
        checks[f"{codec}_losses_finite_falling"] = all(r[codec]["losses_finite_falling"] for r in st)
        checks[f"{codec}_ranks_agree_on_events"] = all(r[codec]["events"] == st[0][codec]["events"]
                                                       for r in st)
    checks["churn_fallbacks_at_most_one_per_stream_per_change"] = all(
        r["churn"]["at_most_one_per_stream_per_change"] and r["churn"]["fallbacks"] > 0
        for r in st)
    checks["churn_bytes_and_launches"] = all(
        r["churn"]["checks"]["bytes_as_byte_model"] and r["churn"]["checks"]["launches_as_designed"]
        for r in st)
    checks["churn_losses_finite"] = all(r["churn"]["losses_finite"] for r in st)
    out["stream"] = {"checks": checks, "seconds": max(r["seconds"] for r in st)}
    for codec in ("none", "int8"):
        out["stream"][codec] = {k: [r[codec][k] for r in st] for k in (
            "inner_ms", "consuming", "blocking", "full_outer_step", "cycle_ms_blocking",
            "cycle_ms_consuming", "sync_by_stream", "peak_gb", "blocking_fraction",
            "warm_presend_wait_ms_in_run")}
        out["stream"][codec]["events"] = st[0][codec]["events"]
    out["stream"]["churn_fallbacks"] = st[0]["churn"]["fallbacks"]
    log("dist stream (phase 51): " + json.dumps(out["stream"]))
    if not all(checks.values()):
        raise AssertionError(f"dist stream failed its checks: {checks}")
    launches["stream"] = {k: sum(r[c]["launches"].get(k, 0) for r in st for c in ("none", "int8"))
                          + sum(r["churn"]["launches"].get(k, 0) for r in st)
                          for k in TRAIN_KERNELS + INT8}

    # phase 52
    par = [r["parity"] for r in ranks]
    checks = {}
    for name in ("elastic", "async", "stream_churn"):
        rows = [r[name] for r in par]
        checks[name] = all(row["rounds_identical"] and row["partners_identical"]
                           and row["stream_events_identical"]
                           and row["loss_max_rel_diff"] <= LOSS_RTOL
                           and row["weight_std_rel_diff"] <= WSTD_RTOL for row in rows)
    for name, mid in (("resume_async", DIST_ASYNC_MID), ("resume_stream", DIST_STREAM_MID)):
        checks[name] = all(r[name]["start_step"] == mid and r[name]["losses_identical"]
                           and r[name]["bit_identical"] for r in par)
    out["card_vs_cpu"] = {"checks": checks, "ranks": par, "seconds": max(r["seconds"] for r in par)}
    out["runs_s_rank0"] = {name: ranks[0][name]["runs_s"] for name in ("elastic", "async", "stream",
                                                                       "parity")}
    log("dist elastic phases' runs on rank 0 (run, s in all, the loop's wall s): "
        + json.dumps(out["runs_s_rank0"]))
    log("dist elastic card vs cpu and resumes (phase 52): " + json.dumps(out["card_vs_cpu"]))
    if not all(checks.values()):
        raise AssertionError(f"dist card vs cpu (phase 52) failed its checks: {checks}")
    return out, launches


# ---------------------------------------------------------------------------
# Phases 53–54: the model axis (tensor parallelism inside a replica)
# ---------------------------------------------------------------------------

# phase 53: paper-small-125m at full width in bf16, 2 replicas × 2 model
# ranks (4 ranks sharing the card over gloo), 4 × 1024 a replica, m 5, 10 steps
DIST_TP = ["--data", "2", "--model", "2", "--batch-per-replica", "4", "--seq", "1024",
           "--steps", "10", "--inner-steps", "5", "--pairing-pool", "16"]
DIST_TP_RUNS = (("noloco", ["--method", "noloco"]),
                ("int8", ["--method", "noloco", "--codec", "int8"]))
# the same run at --model 1 (2 ranks, one a replica): phase 53's comparison,
# and phase 55's (the same flags under gossip_dp)
DIST_TP_MODEL1 = DIST_TP + ["--model", "1", "--method", "noloco"]
DIST_TP_SMALL = ["--data", "2", "--model", "2", "--reduced", "--batch-per-replica", "2",
                 "--seq", "64", "--steps", "10", "--inner-steps", "5"]
DIST_TP_MID = 5
# the losses of the first inner period (steps 1-5, before any outer step)
# against the same run at --model 1, relative: bf16 sums in other orders.
# Read on the H100: step 1 2.5e-6 / 8.7e-6 (the two replicas), steps 2-5 up
# to 2.06e-4 (AdamW's first updates of bf16 weights from gradients summed in
# other orders); each bound is about ten times its reading
TP_STEP1_RTOL = 1e-4
TP_PERIOD_RTOL = 2e-3
# phase 54: qwen3-0.6b in fp32 at --data 1 --model 2, 4 rows, 32-token
# prompts, a cache of 256, 32 greedy steps
TP_SERVE = dict(rows=4, prompt=32, cache=256, steps=32)


def _model_axis_counted(trainer, group, per_step: list) -> None:
    """Wrap the trainer's inner step: the model axis's calls and bytes of
    each step."""
    inner_step = trainer.inner_step

    def inner(state, batch):
        calls, sent = dict(group.model.calls), dict(group.model.sent_bytes)
        out = inner_step(state, batch)
        per_step.append({"calls": _minus(dict(group.model.calls), calls),
                         "bytes": sum(group.model.sent_bytes.values()) - sum(sent.values())})
        return out

    trainer.inner_step = inner


def model_axis_calls(cfg, n_dtypes: int) -> int:
    """The model-axis calls of one inner step of a dense model, as the
    design in ``parallel/steps.py``'s docstring counts them: forward 2L + 4,
    backward 2L + 3, one all-reduce of the whole leaves' gradients for each
    of their ``n_dtypes`` dtypes and one of the clipping norm's squares,
    plus L under ``cfg.remat``."""
    layers = cfg.num_layers
    return 4 * layers + 8 + n_dtypes + (layers if cfg.remat else 0)


def time_model_axis(group, shape=(4, 1024, 768), dtype=torch.bfloat16, reps: int = 5) -> dict:
    """The model axis's all-reduce of one activation (an MLP output of the
    run), ms (median of ``reps``, each synchronised), and its bytes."""
    x = torch.ones(shape, dtype=dtype, device=group.device)
    samples = []
    for _ in range(reps + 1):
        _sync(group.device)
        t = time.perf_counter()
        group.model.all_reduce(x)
        _sync(group.device)
        samples.append((time.perf_counter() - t) * 1e3)
    return {"all_reduce_ms": statistics.median(samples[1:]),
            "bytes": x.numel() * x.element_size(), "shape": list(shape)}


def _outer_alone(trainer, group, state) -> tuple[list, dict]:
    """The outer step alone, three times on ``state``, each split into its
    phases by a synchronising clock: the totals (ms) and each phase's ms."""
    from repro_torch.launch import mesh as mesh_lib

    split = {k: [] for k in DIST_PHASES}
    total_ms = []
    for _ in range(3):
        clock = mesh_lib.PhaseClock(group.device)
        group.barrier()
        t0 = time.perf_counter()
        group.clock = clock
        clock.start()
        trainer.maybe_outer_step(state)
        clock.mark("update")
        group.clock = None
        total_ms.append((time.perf_counter() - t0) * 1e3)
        for k in DIST_PHASES:
            split[k].append(clock.ms.get(k, 0.0))
    return total_ms, split


def dist_tp_full_run(group, argv, base=DIST_TP, device="cuda") -> dict:
    """One run of ``base + argv`` on this rank through ``run_rank``, launch
    counts zeroed just before and read just after; the model axis's calls
    and bytes of every inner step; then the outer step alone, three times
    on the final state, split by a synchronising clock."""
    from repro_torch.launch import train_distributed
    from repro_torch.parallel import steps as psteps

    dev = group.device
    args = _dist_args(base + argv, device, group.backend)
    trainer = train_distributed.make_trainer(args, group)
    cfg = trainer.cfg
    syncs: list = []
    inner_calls: dict = {}
    per_step: list = []
    _dist_counted(trainer, group, syncs, inner_calls)
    _model_axis_counted(trainer, group, per_step)
    whole = {str(x.dtype) for x, s in zip(tree_leaves(bytes_model.abstract_params(cfg)),
                                          psteps.leaf_mask(cfg, trainer.plan)) if not s}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    group.barrier()
    dispatch.reset_launches()
    out = train_distributed.run_rank(group, args, trainer=trainer)
    _sync(dev)
    launches = _launch_counts(dev)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
    res, state = out["result"], out["result"]["state"]
    m = args.inner_steps
    inner = [dt * 1e3 for t, dt in enumerate(res["step_dt_s"]) if t and (t + 1) % m]
    total_ms, split = _outer_alone(trainer, group, state)
    axis_ms = time_model_axis(group, (args.batch_per_replica, args.seq, cfg.d_model),
                              torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)
    row = {
        "rank": group.rank, "replica": group.replica, "model_index": group.model_index,
        "losses": res["losses"], "launches": launches,
        "inner_step_p50_ms": statistics.median(inner), "inner_step_p99_ms": _pct(inner, 0.99),
        "outer_step_alone_ms": statistics.median(total_ms),
        "outer_split_ms": {k: statistics.median(v) for k, v in split.items()},
        "sync_calls": [s["calls"] for s in syncs[:res["outer_syncs"]]],
        "sync_bytes": [s["bytes"] for s in syncs[:res["outer_syncs"]]],
        "outer_syncs": res["outer_syncs"], "replica_axis_inner_calls": inner_calls,
        "model_calls_per_step": [sum(s["calls"].values()) for s in per_step],
        "model_calls_by_kind": per_step[0]["calls"] if per_step else {},
        "model_bytes_per_step": [s["bytes"] for s in per_step],
        "model_calls_design": model_axis_calls(cfg, len(whole)),
        "model_axis": axis_ms, "peak_memory_gb": peak_gb,
        "partners": [p.tolist() for p in trainer.partners[:res["outer_syncs"]]],
        "final_weight_std": res["final_weight_std"], "summary": out["summary"],
        "staged": group.staged,
    }
    del out, res, state, trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


def _cpu_view(group):
    """The rank's group with its tensors on the CPU (gloo, unstaged), the
    same process groups."""
    from repro_torch.launch import mesh as mesh_lib

    cpu = torch.device("cpu")
    model = None if group.model is None else mesh_lib.ModelAxis(
        group.model.pg, group.model.ranks, group.model.index, cpu, group.backend)
    return dataclasses.replace(group, device=cpu, calls=type(group.calls)(),
                               sent_bytes=type(group.sent_bytes)(), _pinned={}, model=model)


def dist_tp_rank(group, ckpt_root: str) -> dict:
    """Phase 53 on one rank: the full-width runs, then fp32 reduced() on
    the card and on a CPU view of the same ranks, and a resume on the card
    from a step-5 checkpoint."""
    out = {"full": {name: dist_tp_full_run(group, argv) for name, argv in DIST_TP_RUNS}}
    card_run, card_tr = dist_small_run(group, DIST_TP_SMALL, "cuda")
    cpu_run, cpu_tr = dist_small_run(_cpu_view(group), DIST_TP_SMALL, "cpu")
    out["parity"] = {
        "loss_max_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(card_run["losses"],
                                                                       cpu_run["losses"])),
        "partners_identical": [p.tolist() for p in card_tr.partners]
        == [p.tolist() for p in cpu_tr.partners] and len(card_tr.partners) == 2}
    whole = os.path.join(ckpt_root, "whole")
    half = os.path.join(ckpt_root, "half")
    a, a_tr = dist_small_run(group, DIST_TP_SMALL, "cuda", ckpt_dir=whole, ckpt_every=DIST_TP_MID)
    dist_small_run(group, DIST_TP_SMALL, "cuda", ckpt_dir=half, steps=DIST_TP_MID)
    b, _ = dist_small_run(group, DIST_TP_SMALL, "cuda", ckpt_dir=half, resume=True)
    same = all(torch.equal(x, y) for k in ("theta", "phi", "delta", "mu", "nu")
               for x, y in zip(tree_leaves(_dist_rows(a["state"])[k]),
                               tree_leaves(_dist_rows(b["state"])[k])))
    out["resume"] = {"start_step": b["start_step"],
                     "losses_identical": b["losses"] == a["losses"][DIST_TP_MID:],
                     "bit_identical": bool(same)}
    return out


def dist_tp_model1_rank(group, base=DIST_TP_MODEL1) -> dict:
    """Phase 53's plain run at ``--model 1`` on one rank (2 ranks, one per
    replica, from the same seed's weights and batches), the comparison of
    phases 53 and 55: its losses, partner tables, inner p50 and peak
    memory.  The rank's device is the group's (a CPU rehearsal passes a
    ``--reduced`` base)."""
    from repro_torch.launch import train_distributed

    dev = group.device
    args = _dist_args(base, dev.type, group.backend)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = train_distributed.run_rank(group, args)
    res = out["result"]
    m = args.inner_steps
    inner = [dt * 1e3 for t, dt in enumerate(res["step_dt_s"]) if t and (t + 1) % m]
    return {"losses": res["losses"], "peak_memory_gb": _peak_gb(dev),
            "inner_step_p50_ms": statistics.median(inner),
            "partners": [p.tolist() for p in out["trainer"].partners[:res["outer_syncs"]]]}


def dist_tp_phase(dev) -> tuple[dict, dict]:
    """Phase 53: paper-small-125m at full width in bf16 on 2 replicas × 2
    model ranks sharing the card over gloo; NoLoCo on the plain and the
    int8 wire; then reduced() in fp32, card against CPU, and a resume."""
    from repro_torch.launch import mesh as mesh_lib

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = paper_llama.SMALL
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_tp_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ranks = mesh_lib.spawn(dist_tp_rank, 4, (root,), backend="gloo", device="cuda", tp=2)
    shutil.rmtree(root, ignore_errors=True)
    model1 = mesh_lib.spawn(dist_tp_model1_rank, 2, (), backend="gloo", device="cuda")
    partners1 = model1[0]["partners"]
    period = [r["losses"][:DIST_TP_MID] for r in model1]   # by replica
    out, launches = {"card": card(), "world": 4, "tp": 2, "backend": "gloo",
                     "model1": model1}, {}
    for name, _ in DIST_TP_RUNS:
        rows = [r["full"][name] for r in ranks]
        want = dist_expected(cfg, name, 2)
        checks = {
            "launches_as_designed": all({k: r["launches"][k] for k in want} == want
                                        for r in rows),
            "model_calls_as_designed": all(
                c == r["model_calls_design"] for r in rows for c in r["model_calls_per_step"])
            and all(len(r["model_calls_per_step"]) == 10 for r in rows),
            "no_replica_axis_call_in_inner_steps": all(not any(r["replica_axis_inner_calls"].values())
                                                       for r in rows),
            "syncs_p2p_only": all(c == {"p2p": 1} for r in rows for c in r["sync_calls"])
            and all(r["outer_syncs"] == 2 for r in rows),
            "losses_finite_falling": all(all(math.isfinite(x) for x in r["losses"])
                                         and r["losses"][-1] < r["losses"][0] for r in rows),
            "model_ranks_agree_on_losses": all(a["losses"] == b["losses"]
                                               for a, b in zip(rows[0::2], rows[1::2])),
            "partners_as_model1_run": all(r["partners"] == partners1 for r in rows),
            "step1_loss_as_model1_run": all(
                abs(r["losses"][0] - period[r["replica"]][0]) <= TP_STEP1_RTOL
                * abs(period[r["replica"]][0]) for r in rows),
            "first_period_losses_as_model1_run": all(
                abs(a - b) <= TP_PERIOD_RTOL * abs(b)
                for r in rows for a, b in zip(r["losses"][:DIST_TP_MID], period[r["replica"]]))
            and all(len(r["losses"]) == 10 for r in rows),
        }
        launches[name] = {k: sum(r["launches"].get(k, 0) for r in rows) for k in TRAIN_KERNELS + INT8}
        out[name] = {
            "checks": checks, "summary": rows[0]["summary"], "partners": rows[0]["partners"],
            "first_period_losses": [r["losses"][:DIST_TP_MID] for r in rows[0::2]],
            "first_period_model1": period,
            "first_period_max_rel_diff": max(
                abs(a - b) / abs(b)
                for r in rows for a, b in zip(r["losses"][:DIST_TP_MID], period[r["replica"]])),
            "inner_step_p50_ms": [r["inner_step_p50_ms"] for r in rows],
            "inner_step_p99_ms": [r["inner_step_p99_ms"] for r in rows],
            "outer_step_alone_ms": [r["outer_step_alone_ms"] for r in rows],
            "outer_split_ms": [r["outer_split_ms"] for r in rows],
            "sync_bytes": [r["sync_bytes"][0] for r in rows],
            "peak_memory_gb": [r["peak_memory_gb"] for r in rows],
            "model_calls_per_step": rows[0]["model_calls_per_step"][0],
            "model_calls_design": rows[0]["model_calls_design"],
            "model_calls_by_kind": rows[0]["model_calls_by_kind"],
            "model_bytes_per_step": rows[0]["model_bytes_per_step"][0],
            "model_axis": [r["model_axis"] for r in rows],
            "flash_launches_per_rank": [{k: r["launches"][k] for k in TRAIN_KERNELS[:2]}
                                        for r in rows],
            "loss_first_last": [[r["losses"][0], r["losses"][-1]] for r in rows],
            "final_weight_std": rows[0]["final_weight_std"],
        }
        log(f"dist-tp {name} (2 replicas × 2 model ranks, gloo, staged={rows[0]['staged']}): "
            + json.dumps(out[name]))
        if not all(checks.values()):
            raise AssertionError(f"dist-tp {name} failed its checks: {checks}")
    for r in ranks:
        par, res = r["parity"], r["resume"]
        if not (par["partners_identical"] and par["loss_max_rel_diff"] <= LOSS_RTOL):
            raise AssertionError(f"dist-tp fp32 card vs cpu: {par}")
        if not (res["start_step"] == DIST_TP_MID and res["losses_identical"]
                and res["bit_identical"]):
            raise AssertionError(f"dist-tp resume on card: {res}")
    out["card_vs_cpu"] = [r["parity"] for r in ranks]
    out["resume"] = [r["resume"] for r in ranks]
    log("dist-tp fp32 card vs cpu (4 ranks): " + json.dumps(out["card_vs_cpu"]))
    log("dist-tp resume on card from step 5: " + json.dumps(out["resume"]))
    out["seconds"] = time.perf_counter() - t_phase
    return out, launches


def tp_greedy(params, cfg, prompt, steps, cache, prefill, decode, logits_of, dev) -> dict:
    """Prefill ``prompt`` and decode ``steps`` greedy tokens: the tokens,
    every step's fp32 logits (rows, V) on the CPU, the prefill's ms and
    each decode step's ms (synchronised)."""
    _sync(dev)
    t = time.perf_counter()
    hidden = prefill(params, cache, {"tokens": prompt})
    logits = logits_of(hidden)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t) * 1e3
    tokens, all_logits, step_ms = [], [logits[:, 0].float().cpu()], []
    tok = logits[:, -1].argmax(-1, keepdim=True)
    for i in range(steps):
        tokens.append(tok.cpu())
        _sync(dev)
        t = time.perf_counter()
        logits = decode(params, cache, tok, prompt.shape[1] + i)
        _sync(dev)
        step_ms.append((time.perf_counter() - t) * 1e3)
        all_logits.append(logits[:, 0].float().cpu())
        tok = logits[:, -1].argmax(-1, keepdim=True)
    tokens.append(tok.cpu())
    return {"tokens": torch.cat(tokens, 1), "logits": torch.stack(all_logits),
            "prefill_ms": prefill_ms, "step_ms": step_ms}


def tp_serve_inputs(cfg, dev):
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompt = torch.randint(0, cfg.vocab_size, (TP_SERVE["rows"], TP_SERVE["prompt"]),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    return params, prompt


def dist_tp_decode_rank(group, ref_path: str) -> dict:
    """Phase 54 on one rank: the rank's shard of qwen3-0.6b in fp32 and its
    part of the caches (every global layer's sequence split), through
    ``build_prefill_step`` + ``build_decode_step``; the gathered logits and
    tokens against the unsharded run's."""
    from repro_torch.parallel import plans, steps as psteps

    dev = group.device
    cfg = dataclasses.replace(qwen3_0_6b.CONFIG, dtype="float32")
    plan = plans.make_plan("gossip_dp", 1, group.tp, shape_kind="decode")
    ctx = plan.ctx(group.model)
    full, prompt = tp_serve_inputs(cfg, dev)
    theta = psteps.shard_params(full, cfg, plan, group.model_index, stacked=False)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cache = M.init_cache_tree(cfg, TP_SERVE["rows"], TP_SERVE["cache"], device=dev, ctx=ctx)
    prefill = psteps.build_prefill_step(cfg, plan, group)
    decode = psteps.build_decode_step(cfg, plan, group)
    gather = lambda lg: psteps.gather_logits(lg, cfg, plan, group)
    with torch.no_grad():
        logits_of = lambda h: gather(logits_sharded(theta["embed"], cfg, h, ctx))
        group.barrier()
        calls0 = dict(group.model.calls)
        dispatch.reset_launches()
        run = tp_greedy(theta, cfg, prompt, TP_SERVE["steps"], cache,
                        lambda p, c, b: prefill(p, c, b)[0],
                        lambda p, c, t, i: gather(decode(p, c, t, i)[0]), logits_of, dev)
        launches = _launch_counts(dev)
    ref = torch.load(ref_path)
    return {"rank": group.rank, "tokens_equal": torch.equal(run["tokens"], ref["tokens"]),
            "max_abs_logit_diff": float((run["logits"] - ref["logits"]).abs().max()),
            "prefill_ms": run["prefill_ms"], "step_p50_ms": statistics.median(run["step_ms"]),
            "step_p99_ms": _pct(run["step_ms"], 0.99), "launches": launches,
            "model_calls": _minus(dict(group.model.calls), calls0),
            "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "cache_slots_per_rank": TP_SERVE["cache"] // group.tp}


def dist_tp_decode_phase(dev) -> tuple[dict, dict]:
    """Phase 54: qwen3-0.6b in fp32 at ``--data 1 --model 2`` (2 ranks
    sharing the card, ``kv_shard_seq``) through ``build_prefill_step`` +
    ``build_decode_step``: the greedy tokens equal the unsharded
    ``model.prefill`` / ``decode_step`` run's on the card, logits within
    LOGIT_ATOL; the step p50 beside the unsharded one."""
    from repro_torch.launch import mesh as mesh_lib

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(qwen3_0_6b.CONFIG, dtype="float32")
    params, prompt = tp_serve_inputs(cfg, dev)
    cache = M.init_cache_tree(cfg, TP_SERVE["rows"], TP_SERVE["cache"], device=dev)
    with torch.no_grad():
        ref = tp_greedy(params, cfg, prompt, TP_SERVE["steps"], cache,
                        lambda p, c, b: M.prefill(p, cfg, b, c)[0],
                        lambda p, c, t, i: M.decode_step(p, cfg, t, i, c)[0],
                        lambda h: logits_sharded(params["embed"], cfg, h), dev)
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_tp_ref.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"tokens": ref["tokens"], "logits": ref["logits"]}, path)
    ranks = mesh_lib.spawn(dist_tp_decode_rank, 2, (path,), backend="gloo", device="cuda", tp=2)
    os.remove(path)
    out = {"card": card(), "ranks": ranks, "unsharded_step_p50_ms": statistics.median(ref["step_ms"]),
           "unsharded_prefill_ms": ref["prefill_ms"], "config": dict(TP_SERVE, arch=cfg.name,
                                                                   dtype=cfg.dtype)}
    checks = {"tokens_equal": all(r["tokens_equal"] for r in ranks),
              "logits_within_atol": all(r["max_abs_logit_diff"] <= LOGIT_ATOL for r in ranks),
              "flash_in_prefill": all(r["launches"].get("flash_attention", 0) == cfg.num_layers
                                      for r in ranks)}
    out["checks"] = checks
    out["seconds"] = time.perf_counter() - t_phase
    log("dist-tp decode (phase 54): " + json.dumps(out))
    if not all(checks.values()):
        raise AssertionError(f"dist-tp decode failed its checks: {checks}")
    return out, {k: sum(r["launches"].get(k, 0) for r in ranks) for k in TRAIN_KERNELS}


def dist_tp_card_rank(group, data: int) -> dict:
    """Phase 48's model-axis rank: phase 53's plain run, one card a rank."""
    row = dist_tp_full_run(group, ["--data", str(data)] + DIST_TP_RUNS[0][1])
    return {k: row[k] for k in ("rank", "inner_step_p50_ms", "inner_step_p99_ms",
                                "outer_step_alone_ms", "model_axis", "model_calls_per_step",
                                "model_calls_design", "model_bytes_per_step", "peak_memory_gb",
                                "staged", "losses")}


# ---------------------------------------------------------------------------
# Phase 55: the fsdp_hybrid plan (ZeRO-3 over a data axis inside each pod)
# ---------------------------------------------------------------------------

# paper-small-125m at full width and depth in bf16, 2 pods × 2 data ranks (4
# ranks sharing the card over gloo), 4 × 1024 a pod (2 × 1024 a data rank),
# NoLoCo m 5, 10 steps: phase 53's run at --model 1 under fsdp_hybrid, and
# that run (gossip_dp, 2 ranks, one a replica) its comparison
FSDP_PODS, FSDP_DATA = 2, 2
DIST_FSDP = DIST_TP_MODEL1
DATA_KINDS = ("all_gather", "reduce_scatter", "all_reduce")


def fsdp_plan():
    from repro_torch.parallel import plans

    return plans.make_plan("fsdp_hybrid", FSDP_DATA, pod=FSDP_PODS)


def _nbytes(leaf) -> int:
    return math.prod(leaf.shape) * getattr(torch, leaf.dtype).itemsize


def shard_struct(cfg, plan):
    """One replica's leaves as a rank holds them under ``plan``
    (``payload.LeafShape``): each global shape with the dimension the model
    axis splits and the one the data axis splits cut."""
    from repro_torch.models.logical import logical_axes
    from repro_torch.parallel import plans

    def one(leaf, ax):
        shape = list(leaf.shape)
        for dim, n in ((plans.shard_dim(ax.names, leaf.shape, plan), plan.tp),
                       (plans.fsdp_dim(ax.names, leaf.shape, plan), plan.fsdp)):
            if dim is not None:
                shape[dim] //= n
        return payload.LeafShape(tuple(shape), leaf.dtype)

    return tree_map(one, bytes_model.abstract_params(cfg), logical_axes(cfg))


def data_axis_design(cfg, plan) -> dict:
    """The data axis's calls (by kind) and the bytes a rank hands to them in
    one inner step of a dense decoder, as ``parallel/steps.py``'s docstring
    counts them: one all-gather of the rank's block per use of a leaf split
    on ``"fsdp"`` (each layer's leaves once per layer, twice under remat,
    whose backward recomputes the layers of full periods; the embedding
    table twice when the logits share it), one reduce-scatter of the whole
    weight's gradient per use, one all-reduce per dtype of the leaves held
    whole over the axis (their gradients), one of the clipping norm's
    squares (fp32, one per replica) and one of the loss."""
    from repro_torch.models.logical import logical_axes
    from repro_torch.parallel import plans

    full, shard, axes = bytes_model.abstract_params(cfg), shard_struct(cfg, plan), logical_axes(cfg)
    _, n_full, _ = tfm.layer_plan(cfg)
    uses = []   # (full leaf, shard leaf, axes, uses a step, layers the leaf stacks)
    for f, s, ax in zip(tree_leaves(full["stack"]["scan"]), tree_leaves(shard["stack"]["scan"]),
                        tree_leaves(axes["stack"]["scan"])):
        uses.append((f, s, ax, n_full, n_full, cfg.remat))
    for f, s, ax in zip(tree_leaves(full["stack"]["rem"]), tree_leaves(shard["stack"]["rem"]),
                        tree_leaves(axes["stack"]["rem"])):
        uses.append((f, s, ax, 1, 1, False))
    for name in full["embed"]:
        n = 2 if name == "table" and cfg.tie_embeddings else 1
        uses.append((full["embed"][name], shard["embed"][name], axes["embed"][name], n, 1, False))
    calls, sent = dict.fromkeys(DATA_KINDS, 0), 0
    whole = [(f, ax) for f, ax in zip(tree_leaves(full), tree_leaves(axes))
             if plans.fsdp_dim(ax.names, f.shape, plan) is None]
    for f, s, ax, n, stacked, remat in uses:
        if plans.fsdp_dim(ax.names, f.shape, plan) is None:
            continue
        gathers = n * (2 if remat else 1)
        calls["all_gather"] += gathers
        calls["reduce_scatter"] += n
        sent += gathers * _nbytes(s) // stacked + n * _nbytes(f) // stacked
    calls["all_reduce"] = len({f.dtype for f, _ in whole}) + 2
    sent += sum(_nbytes(f) for f, _ in whole) + 4 + 4
    return {"calls": calls, "bytes": sent}


def fsdp_state_design(cfg, plan) -> int:
    """A rank's resident training state from its shard shapes: θ, φ and δ in
    each leaf's dtype, AdamW's two fp32 moments, the int32 step count."""
    return sum(math.prod(s.shape) * (3 * getattr(torch, s.dtype).itemsize + 8)
               for s in tree_leaves(shard_struct(cfg, plan))) + 4


def _data_axis_timed(trainer, axis, per_step: list) -> None:
    """Wrap the data axis's calls and the trainer's inner step: each step's
    calls by kind, the bytes handed to them and the ms spent in them (each
    call synchronised before and after)."""
    spent = [0.0]
    for kind in DATA_KINDS:
        def timed(*a, __fn=getattr(axis, kind), **k):
            _sync(axis.device)
            t = time.perf_counter()
            y = __fn(*a, **k)
            _sync(axis.device)
            spent[0] += (time.perf_counter() - t) * 1e3
            return y

        setattr(axis, kind, timed)
    inner_step = trainer.inner_step

    def inner(state, batch):
        calls, sent = dict(axis.calls), sum(axis.sent_bytes.values())
        spent[0] = 0.0
        out = inner_step(state, batch)
        per_step.append({"calls": _minus(dict(axis.calls), calls),
                         "bytes": sum(axis.sent_bytes.values()) - sent, "ms": spent[0]})
        return out

    trainer.inner_step = inner


def _peak_gb(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0


def dist_fsdp_rank(group, base=DIST_FSDP) -> dict:
    """Phase 55 on one rank: the run of ``base`` through ``run_rank`` with
    the trainer built on the ``fsdp_hybrid`` plan, launch counts zeroed just
    before and read just after, the data axis's calls, bytes and ms of
    every inner step, each sync's calls and bytes, the resident state's
    bytes; then the outer step alone, three times on the final state, split
    by the clock.  The rank's device is the group's (a CPU rehearsal passes
    a ``--reduced`` base)."""
    from repro_torch.launch import train_distributed

    dev = group.device
    args = _dist_args(base, dev.type, group.backend)
    trainer = train_distributed.make_trainer(args, group, plan=fsdp_plan())
    syncs: list = []
    inner_calls: dict = {}
    per_step: list = []
    _dist_counted(trainer, group, syncs, inner_calls)
    _data_axis_timed(trainer, group.data, per_step)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    group.barrier()
    dispatch.reset_launches()
    out = train_distributed.run_rank(group, args, trainer=trainer)
    _sync(dev)
    launches = _launch_counts(dev)
    peak_gb = _peak_gb(dev)
    res, state = out["result"], out["result"]["state"]
    m = args.inner_steps
    steady = [t for t in range(len(res["step_dt_s"])) if t and (t + 1) % m]
    inner = [res["step_dt_s"][t] * 1e3 for t in steady]
    resident = [*tree_leaves(state["theta"]), *tree_leaves(state["opt"].mu),
                *tree_leaves(state["opt"].nu), *tree_leaves(state["phi"]),
                *tree_leaves(state["delta"]), state["opt"].count]
    total_ms, split = _outer_alone(trainer, group, state)
    row = {
        "rank": group.rank, "replica": group.replica, "data_index": group.data_index,
        "losses": res["losses"], "launches": launches,
        "inner_step_p50_ms": statistics.median(inner), "inner_step_p99_ms": _pct(inner, 0.99),
        "data_axis_share": sum(per_step[t]["ms"] for t in steady) / sum(inner),
        "data_axis_ms_p50": statistics.median(per_step[t]["ms"] for t in steady),
        "outer_step_alone_ms": statistics.median(total_ms),
        "outer_split_ms": {k: statistics.median(v) for k, v in split.items()},
        "sync_calls": [s["calls"] for s in syncs[:res["outer_syncs"]]],
        "sync_bytes": [s["bytes"] for s in syncs[:res["outer_syncs"]]],
        "outer_syncs": res["outer_syncs"], "replica_axis_inner_calls": inner_calls,
        "data_calls": [s["calls"] for s in per_step],
        "data_bytes": [s["bytes"] for s in per_step],
        "state_bytes": sum(t.numel() * t.element_size() for t in resident),
        "peak_memory_gb": peak_gb,
        "partners": [p.tolist() for p in trainer.partners[:res["outer_syncs"]]],
        "final_weight_std": res["final_weight_std"], "staged": group.staged,
    }
    del out, res, state, trainer, resident
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


def dist_fsdp_phase(dev, gossip: list[dict]) -> tuple[dict, dict]:
    """Phase 55: paper-small-125m at full width and depth in bf16 under
    ``fsdp_hybrid`` on 2 pods × 2 data ranks sharing the card over gloo,
    NoLoCo; beside it ``gossip``, the ranks' rows of the same run under
    ``gossip_dp`` (phase 53's ``--model 1`` run, ``dist_tp_model1_rank``)."""
    from repro_torch.launch import mesh as mesh_lib

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    plan = fsdp_plan()
    ranks = mesh_lib.spawn(dist_fsdp_rank, plan.world, (), backend="gloo", device="cuda",
                           fsdp=FSDP_DATA)
    out = dict(dist_fsdp_checks(paper_llama.SMALL, plan, ranks, gossip), card=card(),
               seconds=time.perf_counter() - t_phase)
    log("dist-fsdp (phase 55: 2 pods × 2 data ranks, gloo): " + json.dumps(out))
    if not all(out["checks"].values()):
        raise AssertionError(f"dist-fsdp failed its checks: {out['checks']}")
    return out, {"noloco": {k: sum(r["launches"].get(k, 0) for r in ranks)
                            for k in TRAIN_KERNELS + INT8}}


def dist_fsdp_checks(cfg, plan, ranks: list[dict], gossip: list[dict]) -> dict:
    """Phase 55's checks and readings from the ranks' rows (``cfg``: the
    config they trained)."""
    from repro_torch.parallel import steps as psteps

    design = data_axis_design(cfg, plan)
    state_design = fsdp_state_design(cfg, plan)
    sync_design = bytes_model.outer_step_cost(shard_struct(cfg, plan), CommConfig(),
                                              method="noloco").payload_bytes
    whole = sum(_nbytes(s) for s, split in zip(tree_leaves(bytes_model.abstract_params(cfg)),
                                                psteps.leaf_mask(cfg, plan, "data")) if not split)
    replica_payload = bytes_model.outer_step_cost(bytes_model.abstract_params(cfg), CommConfig(),
                                                  method="noloco").payload_bytes
    want = dist_expected(cfg, "noloco", 2)
    period = [r["losses"][:DIST_TP_MID] for r in gossip]   # by pod
    pods = [ranks[p * FSDP_DATA:(p + 1) * FSDP_DATA] for p in range(FSDP_PODS)]
    checks = {
        "launches_as_designed": all({k: r["launches"].get(k, 0) for k in want} == want
                                    for r in ranks),
        "data_calls_as_designed": all(c == design["calls"] for r in ranks for c in r["data_calls"])
        and all(len(r["data_calls"]) == 10 for r in ranks),
        "data_bytes_as_designed": all(b == design["bytes"] for r in ranks for b in r["data_bytes"]),
        "state_bytes_as_designed": all(r["state_bytes"] == state_design for r in ranks),
        "no_replica_axis_call_in_inner_steps": all(not any(r["replica_axis_inner_calls"].values())
                                                   for r in ranks),
        "syncs_p2p_only": all(c == {"p2p": 1} for r in ranks for c in r["sync_calls"])
        and all(r["outer_syncs"] == 2 for r in ranks),
        "sync_bytes_as_byte_model": all(b == sync_design for r in ranks for b in r["sync_bytes"])
        and all(sum(r["sync_bytes"][0] for r in pod) == replica_payload + 2 * whole
                * (FSDP_DATA - 1) for pod in pods),
        "losses_finite_falling": all(all(math.isfinite(x) for x in r["losses"])
                                     and r["losses"][-1] < r["losses"][0] for r in ranks),
        "data_ranks_agree_on_losses": all(r["losses"] == pod[0]["losses"] for pod in pods
                                          for r in pod),
        "partners_as_gossip_run": all(r["partners"] == gossip[0]["partners"] for r in ranks)
        and len(gossip[0]["partners"]) == 2,
        "step1_loss_as_gossip_run": all(
            abs(r["losses"][0] - period[r["replica"]][0]) <= TP_STEP1_RTOL
            * abs(period[r["replica"]][0]) for r in ranks),
        "first_period_losses_as_gossip_run": all(
            abs(a - b) <= TP_PERIOD_RTOL * abs(b)
            for r in ranks for a, b in zip(r["losses"][:DIST_TP_MID], period[r["replica"]]))
        and all(len(r["losses"]) == 10 for r in ranks),
    }
    out = {
        "world": plan.world, "pods": FSDP_PODS, "fsdp": FSDP_DATA,
        "backend": "gloo", "staged": ranks[0]["staged"], "checks": checks,
        "first_period_losses": [pod[0]["losses"][:DIST_TP_MID] for pod in pods],
        "first_period_gossip": period,
        "first_period_max_rel_diff": max(
            abs(a - b) / abs(b)
            for r in ranks for a, b in zip(r["losses"][:DIST_TP_MID], period[r["replica"]])),
        "inner_step_p50_ms": [r["inner_step_p50_ms"] for r in ranks],
        "inner_step_p99_ms": [r["inner_step_p99_ms"] for r in ranks],
        "gossip_inner_step_p50_ms": [r["inner_step_p50_ms"] for r in gossip],
        "data_axis_share": [r["data_axis_share"] for r in ranks],
        "data_axis_ms_p50": [r["data_axis_ms_p50"] for r in ranks],
        "data_calls_per_step": ranks[0]["data_calls"][0], "data_calls_design": design["calls"],
        "data_bytes_per_step": ranks[0]["data_bytes"][0], "data_bytes_design": design["bytes"],
        "state_bytes": [r["state_bytes"] for r in ranks], "state_bytes_design": state_design,
        "outer_step_alone_ms": [r["outer_step_alone_ms"] for r in ranks],
        "outer_split_ms": [r["outer_split_ms"] for r in ranks],
        "sync_bytes": [r["sync_bytes"][0] for r in ranks], "sync_bytes_design": sync_design,
        "peak_memory_gb": [r["peak_memory_gb"] for r in ranks],
        "gossip_peak_memory_gb": [r["peak_memory_gb"] for r in gossip],
        "loss_first_last": [[r["losses"][0], r["losses"][-1]] for r in ranks],
        "partners": ranks[0]["partners"], "final_weight_std": ranks[0]["final_weight_std"],
    }
    return out


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return None if tree is None else tree.to(device)


# ---------------------------------------------------------------------------


def _time_phases() -> None:
    """Log each phase function's seconds when it returns (``phase <name>:
    <s> s``), so that the script's time limit can be kept by cutting where
    the time goes."""
    def timed(fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            log(f"phase {fn.__name__}: {time.perf_counter() - t:.1f} s")
            return out
        return run

    for name, fn in list(globals().items()):
        if callable(fn) and re.search(r"(_phase|_kernels|_parity|^time_moe_block)$", name):
            globals()[name] = timed(fn)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _time_phases()
    build.build_all()
    for name, (secs, report) in build.BUILD_LOG.items():
        log(f"build {name}.cu: {secs:.1f} s\n{report.strip()}")
    log(f"build: {time.perf_counter() - t0:.1f} s")

    errors = {**check_kernels(dev), **check_train_kernels(dev), **check_int8_kernels(dev)}
    for name, err in (*check_recurrent_kernels(dev).items(), *check_split_kernels(dev).items(),
                      *check_recurrent_bwd_kernels(dev).items(),
                      *check_granite_kernels(dev).items(), *check_frontend_kernels(dev).items()):
        errors[name] = max(errors.get(name, 0.0), err)
    rec_timings, rec_extra = time_recurrent_kernels(dev)
    bwd_timings, bwd_extra = time_recurrent_bwd_kernels(dev)
    rec_extra.update(bwd_extra)
    granite_timings = time_granite_kernels(dev)
    frontend_timings = time_frontend_kernels(dev)
    timings = {**time_kernels(dev), **time_train_kernels(dev), **time_int8_kernels(dev),
               **rec_timings, **bwd_timings}
    sampling = sampling_phase(dev)
    qwen3 = cut(qwen3_0_6b.CONFIG, QWEN3_LAYERS)
    summary, launches = serve_phase(dev, qwen3)
    sampled = serve_phase(dev, qwen3, temps=(0.0, 0.7))[0]
    sampling["after_profile"] = {run: {**{k: r[k] for k in ("step_p50_s", "tokens_per_s")},
                                       **{"profile_" + k: r["profile"][k] for k in (
                                           "device_busy_ms", "wall_ms", "device_ops")}}
                                 for run, r in (("greedy", summary), ("sampled", sampled))}
    log("serve qwen3-0.6b sampled vs greedy: " + json.dumps(sampling["after_profile"]))
    slice_err = slice_phase(dev)
    train_summary, train_launches = train_phase(dev)
    flash_pair = flash_pair_train_phase(train_summary["losses"])
    parity = train_parity_phase(dev)
    int8_summary, int8_launches = int8_train_phase(dev, train_summary)
    int8_parity = train_parity_phase(dev, codec="int8")
    resume = ckpt_phase(dev)
    promoted = promote_serve_phase(dev, resume["dir"])
    family = {}
    for cfg, expected in ((mamba2_370m.CONFIG, mamba2_launches(mamba2_370m.CONFIG)),
                          (recurrentgemma_9b.CONFIG, recurrentgemma_launches(recurrentgemma_9b.CONFIG))):
        family[cfg.name] = serve_phase(dev, cfg, expected)
    rec_parity = recurrent_parity_phase(dev)
    rec_train = {}
    for cfg, run in RECURRENT_TRAIN:
        rec_train[cfg.name] = train_phase(dev, cfg, run, label=f"train {cfg.name}")
    rec_train_parity = recurrent_train_parity_phase(dev)
    granite_serve = serve_phase(dev, GRANITE, granite_launches(GRANITE), solo=False)[0]
    granite_train = train_phase(dev, cut(GRANITE, GRANITE_TRAIN_LAYERS), GRANITE_TRAIN,
                                label=f"train {GRANITE.name}")[0]
    granite_train["moe_block"] = time_moe_block(dev)
    moe_parity = {"serve": moe_serve_parity(dev), "train": moe_train_parity(dev),
                  "archs": archs_parity(dev)}
    whisper_train = whisper_train_phase(dev)[0]
    whisper_serve = whisper_serve_phase(dev)[0]
    internvl = internvl_phase(dev)
    frontend_parity = frontend_parity_phase(dev)
    elastic, elastic_launches = elastic_phase(dev, cut(paper_llama.SMALL, ELASTIC_LAYERS))
    async_summary = async_phase(dev, cut(paper_llama.SMALL, ELASTIC_LAYERS))
    elastic_parity = elastic_parity_phase(dev)
    streamed, streamed_launches = {}, {}
    for codec in ("none", "int8"):
        streamed[codec], streamed_launches[codec] = stream_train_phase(dev, codec, train_summary)
    stream1 = stream1_overlap_phase(dev, train_summary["losses"])
    stream_churn, churn_launches = stream_churn_phase(dev)
    stream_parity = stream_parity_phase(dev)
    piped, piped_launches = {}, {}
    for design, codec, run in (("none", "none", PIPE_RUN), ("int8", "int8", PIPE_RUN),
                               ("4x4", "none", PIPE4_RUN)):
        piped[design], piped_launches[design] = pipe_train_phase(dev, design, codec, run,
                                                                 train_summary)
    pipe_parity = pipe_parity_phase(dev)
    single_shot, single_shot_launches = single_shot_phase(dev)
    spec, spec_launches = {}, []
    for base, variants in spec_runs():
        rows, counts = spec_phase(dev, base, variants)
        spec.setdefault(base.name, {}).update(rows)
        spec_launches.append(counts)
    spec_cli = spec_cli_phase(dev, resume["dir"])
    router = router_phase(dev)
    spec_parity = spec_parity_phase(dev)
    dist, dist_launches = dist_phase(dev)
    dist_el, dist_el_launches = dist_elastic_phase(dev)
    dist_tp, dist_tp_launches = dist_tp_phase(dev)
    dist_tp_decode, dist_tp_decode_launches = dist_tp_decode_phase(dev)
    dist_fsdp, dist_fsdp_launches = dist_fsdp_phase(dev, dist_tp["model1"])
    # each kernel's launches on the paths the kernels line counts, by path
    pick = lambda counts, names: {k: counts[k] for k in names}
    wire = TRAIN_KERNELS + INT8
    by_path = {
        "serve qwen3-0.6b": pick(launches, ("paged_attention", "paged_chunk_attention")),
        "train": pick(train_launches, TRAIN_KERNELS),
        "train int8": pick(int8_launches, INT8),
        "serve mamba2-370m": pick(family["mamba2-370m"][1], ("ssd_chunk", "ssd_decode")),
        "serve recurrentgemma-9b": pick(family["recurrentgemma-9b"][1],
                                        ("rglru_scan", "rglru_decode")),
        "train mamba2-370m": pick(rec_train["mamba2-370m"][1], ("ssd_chunk_bwd",)),
        "train recurrentgemma-9b": pick(rec_train["recurrentgemma-9b"][1], ("rglru_scan_bwd",)),
        **{f"stream {c}": pick(counts, wire) for c, counts in streamed_launches.items()},
        "churn": pick(churn_launches, wire),
        **{f"pipe {d}": pick(counts, wire) for d, counts in piped_launches.items()},
        # the replica group: every rank's launches
        **{f"dist {r}": pick(counts, wire) for r, counts in dist_launches.items()},
        **{f"dist-elastic {r}": pick(counts, wire) for r, counts in dist_el_launches.items()},
        **{f"dist-tp {r}": pick(counts, wire) for r, counts in dist_tp_launches.items()},
        "dist-tp prefill": pick(dist_tp_decode_launches, TRAIN_KERNELS),
        **{f"dist-fsdp {r}": pick(counts, wire) for r, counts in dist_fsdp_launches.items()},
        "single-shot": pick(single_shot_launches, SERVE_KERNELS),
        **{f"spec {i}": pick(c, SERVE_KERNELS) for i, c in enumerate(spec_launches)},
    }
    launches = {name: sum(c.get(name, 0) for c in by_path.values())
                for name in dispatch.registry()}
    log("kernel launches by path: " + json.dumps(
        {p: {k: v for k, v in c.items() if v} for p, c in by_path.items()}))

    kernels = []
    for name, op in dispatch.registry().items():
        t = timings[name]
        kernels.append({
            "name": name, "route": op.route, "source": op.source, "replaces": op.replaces,
            "launches": launches[name], "max_abs_err": errors[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    log(json.dumps({"summary": {k: summary[k] for k in (
        "tokens_per_s", "ttft_p50_s", "ttft_p99_s", "step_p50_s", "decode_steps", "wall_s")},
        "slice_max_logit_diff": slice_err, "train": train_summary,
        "train_flash_pair": {k: flash_pair[k] for k in ("loss_max_rel_diff", "rtol")},
        "train_card_vs_cpu": {k: parity[k] for k in (
            "loss_max_rel_diff", "weight_std_rel_diff", "partner_tables_identical")},
        "train_int8": int8_summary,
        "train_int8_card_vs_cpu": {k: int8_parity[k] for k in (
            "loss_max_rel_diff", "weight_std_rel_diff", "partner_tables_identical")},
        "ckpt_resume": {k: resume[k] for k in (
            "start_step", "losses_identical", "bit_identical", "state_bytes", "save_s",
            "restore_s")},
        "promote_serve": {k: promoted[k] for k in ("promoted", "tokens_identical")},
        "serve_recurrent": {name: {k: fam[0].get(k) for k in (
            "tokens_per_s", "ttft_p50_s", "ttft_p99_s", "step_p50_s", "step_p99_s",
            "decode_steps", "wall_s", "peak_memory_gb")} for name, fam in family.items()},
        "recurrent_card_vs_cpu": rec_parity,
        "train_recurrent": {name: {k: v for k, v in summ.items() if k != "losses"}
                            for name, (summ, _) in rec_train.items()},
        "train_recurrent_card_vs_cpu": {name: {k: row[k] for k in (
            "loss_max_rel_diff", "weight_std_rel_diff", "partner_tables_identical", "launches")}
            for name, row in rec_train_parity.items()},
        "sampling": sampling,
        "recurrent_timings_other_shapes": {k: {f: v[f] for f in ("ms", "plain_ms", "library_ms",
                                                                 "bound_ms", "bound_by")}
                                           for k, v in rec_extra.items()},
        "granite_kernel_timings": {k: {f: v[f] for f in ("ms", "plain_ms", "library_ms",
                                                         "bound_ms", "bound_by")}
                                   for k, v in granite_timings.items()},
        "serve_granite": {k: granite_serve.get(k) for k in (
            "tokens_per_s", "ttft_p50_s", "ttft_p99_s", "step_p50_s", "step_p99_s",
            "decode_steps", "wall_s", "peak_memory_gb")},
        "train_granite": {k: v for k, v in granite_train.items() if k != "losses"},
        "moe_card_vs_cpu": {
            "serve": {k: moe_parity["serve"][k] for k in ("tokens_identical", "routing")},
            "train": {k: moe_parity["train"][k] for k in (
                "loss_max_rel_diff", "weight_std_rel_diff", "partner_tables_identical",
                "routing")},
            "archs": {a: {k: r[k] for k in ("loss_rel_diff", "grad_max_normwise_diff", "routing")}
                      for a, r in moe_parity["archs"].items()}},
        "frontend_kernel_timings": {k: {f: v[f] for f in ("ms", "plain_ms", "library_ms",
                                                          "bound_ms", "bound_by")}
                                    for k, v in frontend_timings.items()},
        "train_whisper": {k: v for k, v in whisper_train.items() if k != "losses"},
        "serve_whisper": whisper_serve,
        "internvl2_76b": {k: v for k, v in internvl.items() if k != "serve"}
        | {"serve": {k: v for k, v in internvl["serve"].items() if k != "tokens"}},
        "frontend_card_vs_cpu": {
            "loss": {a: {k: r[k] for k in ("loss_rel_diff", "grad_max_normwise_diff")}
                     for a, r in frontend_parity["loss"].items()},
            "dense_tokens_identical": {a: r["tokens_identical"]
                                       for a, r in frontend_parity["dense"].items()},
            "train_whisper": {k: frontend_parity["train"][k] for k in (
                "loss_max_rel_diff", "partner_tables_identical")}},
        "elastic": {k: v for k, v in elastic.items() if k != "evals"}
        | {"launches": {k: elastic_launches[k] for k in TRAIN_KERNELS}},
        "async": {k: v for k, v in async_summary.items() if k not in ("losses", "rate1_losses")},
        "elastic_card_vs_cpu": elastic_parity,
        "stream": {codec: {k: v for k, v in row.items() if k not in (
            "step_dt_ms", "sync_launches_in_run", "per_stream_bytes")}
            for codec, row in streamed.items()},
        "stream1_overlap": {k: v for k, v in stream1.items() if k != "losses"},
        "stream_churn": {k: v for k, v in stream_churn.items() if k != "losses"},
        "stream_card_vs_cpu": stream_parity,
        "pipe": {design: {k: v for k, v in row.items() if k not in (
            "outer_step_samples_ms", "routes_first_steps", "top_device_ops_ms")}
            for design, row in piped.items()},
        "pipe_card_vs_cpu": pipe_parity,
        "single_shot": {name: {k: v for k, v in row.items() if k != "launches_design"}
                        for name, row in single_shot.items()},
        "spec": {name: {label: {k: v for k, v in row.items() if k != "launches_design"}
                        for label, row in rows.items()} for name, rows in spec.items()},
        "spec_cli": spec_cli, "router": router, "spec_card_vs_cpu": spec_parity,
        "dist": {k: v for k, v in dist.items() if k not in ("noloco", "int8", "diloco")}
        | {name: {k: dist[name][k] for k in ("inner_step_p50_ms", "outer_step_alone_ms",
                                             "payload_bytes", "peak_memory_gb", "card_used_gb")}
           for name in ("noloco", "int8", "diloco")},
        "dist_elastic": {"elastic": {k: dist_el["elastic"][k] for k in (
            "inner_ms", "warm_start", "peak_gb", "seconds")},
            "async": {k: dist_el["async"][k] for k in ("inner_ms", "peak_gb", "seconds")},
            "stream": {codec: {k: dist_el["stream"][codec][k] for k in (
                "consuming", "blocking", "full_outer_step", "cycle_ms_blocking",
                "cycle_ms_consuming")} for codec in ("none", "int8")},
            "card_vs_cpu": dist_el["card_vs_cpu"]["checks"], "seconds": dist_el["seconds"]},
        "dist_tp": {name: {k: dist_tp[name][k] for k in (
            "checks", "inner_step_p50_ms", "outer_step_alone_ms", "peak_memory_gb",
            "model_calls_per_step", "model_bytes_per_step", "first_period_max_rel_diff")}
            for name in ("noloco", "int8")} | {"seconds": dist_tp["seconds"]},
        "dist_tp_decode": {k: dist_tp_decode[k] for k in (
            "checks", "unsharded_step_p50_ms", "seconds")}
        | {"step_p50_ms": [r["step_p50_ms"] for r in dist_tp_decode["ranks"]],
           "max_abs_logit_diff": max(r["max_abs_logit_diff"] for r in dist_tp_decode["ranks"])},
        "dist_fsdp": {k: dist_fsdp[k] for k in (
            "checks", "inner_step_p50_ms", "data_axis_share", "outer_step_alone_ms",
            "peak_memory_gb", "gossip_peak_memory_gb", "data_calls_per_step",
            "data_bytes_per_step", "first_period_max_rel_diff", "seconds")},
        "seconds": time.perf_counter() - t0}))
    log(f"chip_smoke: all 55 phases in {time.perf_counter() - t0:.1f} s (the build included)")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
