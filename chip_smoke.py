#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. environment — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions; builds every CUDA kernel from ``src/repro_torch/csrc``
   (one ``nvcc`` each, all in parallel) and prints the build time and the
   compiler's register / shared-memory report;
2. kernel B1 (``rm_feature_fused``): the ``-Xptxas -v`` registers and
   spills and the tensor-core instructions of B1's and B2's libraries;
   then B1 against its plain PyTorch version at the decode shape of the
   serving path (x ``[128, 128]``, its chain kernel), at a 4096-row Gram
   shape and at the adult-shaped map that phase 23 featurizes (x ``[20000,
   123]``, poly10, D 4000; its tile kernel), fp32 and bf16, each with the
   profiler's device time and the CUDA-event time, its grid, and two
   bounds (the tensor cores' and the fp32 CUDA cores');
3. kernel B2 (``rm_fused_causal``) against its plain version (out, S and
   n; in fp32 also within 1e-5 x max(1, max |plain|), 3xTF32's precision)
   at the prefill shape (BH 16, T 256) and at a 4096-token prompt (BH 16,
   T 4096), each with padded keys, fp32 and bf16, and at a wide feature
   axis (F 2150) and a 32768-token prompt in fp32; two calls bitwise
   equal; the device memory a call takes beside its inputs, which must
   stay within its outputs and its scratch of at most 32 chunk states;
   times, grids and both bounds as for B1;
4. kernel B6 (``tensor_sketch_fused``): its ``-Xptxas -v`` registers and
   spills and the tensor-core instructions of its library; then against
   its plain version at every row count the tensor_sketch path gives it,
   so at every output group it launches: the decode shape (x ``[64,
   128]``: 4 slots x 16 heads, one launch each for q and k) and the
   prefill shape of each bucket (x ``[512 .. 4096, 128]``: buckets 32 to
   256 x 16 heads), fp32 and bf16, two calls bitwise equal, with the
   profiler's device time, the CUDA-event time, the grid and both bounds
   (the tensor cores' and the fp32 CUDA cores'); the Gram shape ``[4096,
   128]`` also once through ``registry.estimate_gram``, card against CPU;
   and the paper's exp map at d 50, D 4000 (a 2000-column degree block)
   through ``make_feature_map(estimator="tensor_sketch")``, its Gram on the
   card against the CPU's;
5. kernel B5 (``rm_attention_chunked``): its ``-Xptxas -v`` registers and
   spills and the tensor-core instructions of its library; then against
   its plain version at the prefill shape (BH 16, T 256, F 256, dv 128,
   chunk 128, one sequence's keys padded from 200) and at T 32 (chunk 32),
   fp32, also within 1e-5 x max(1, max |plain|) of the plain version in
   float64 (3xTF32's precision), two calls bitwise equal, with the
   profiler's device time, the CUDA-event time, the grid and both bounds
   (the tensor cores' and the fp32 CUDA cores'); the whole two-launch
   causal op also against the O(T^2) direct evaluation;
6. small end-to-end references on the qwen3 SMOKE model in fp32: the rm
   model on the card (kernels) against the same weights on the CPU (plain
   versions); the same for the tensor_sketch model; and on the card, the
   rm model's two-launch path (``fuse_featurize="off"``: B1 + B5) against
   its fused path (B2);
7. the rm slice: qwen3-1.7b at full width and depth, RM attention, random
   weights from a seed, served by the continuous-batching Scheduler
   (4 slots, max_len 256, 8 greedy requests over several prompt buckets).
   Every request must finish, B1 and B2's launch counters must match the
   admissions and decode steps, and a request run alone must give the
   tokens it got in the batch;
8. where the rm slice's time goes: the same workload again on the warm
   engine (its TTFT and tokens/s), then a ``torch.profiler`` window over
   warm decode steps and one bucket-256 prefill: wall time, device busy
   share, the kernels that take the device time, and B1's and B2's share
   of it;
9. the tensor_sketch slice: the same model, workload and checks with
   ``estimator="tensor_sketch"`` (the rm engine is freed first), through
   the two-launch attention path: B6 must launch twice a layer for every
   admission and decode step, B5 once a layer for every admission;
10. where the tensor_sketch slice's time goes, as in phase 8, with B6's and
    B5's device time in each window;
11. kernels B3 (``rm_fused_state``) and B4 (``rm_fused_apply``): their
    ``-Xptxas -v`` registers and spills and the tensor-core instructions
    (``HMMA``/``GMMA``) in their libraries' SASS (``cuobjdump``, where the
    toolkit has it); then against their plain versions at every shape the
    encoder gives them (d = dv = 80, the hubert plan's ``w [5, 163, 80]``
    as the slab both read): the 8 x 1500 encode (BH 128 = 8 clips x 16
    heads, T 1500, unpadded), the same rows padded to T 1536 with
    ``kvalid`` 0 on the last 36 keys, and the 1 x 32768 encode (BH 16, T
    32768), fp32 and bf16 (S, n and the output; in fp32 also within
    1e-5 x max(1, max |plain|), which a dropped 3xTF32 term exceeds),
    each with its grid and split count, two B3 calls bitwise equal, and
    times beside two bounds (the tensor cores' and the fp32 CUDA
    cores'); past the depth they take whole, at the hubert plan on head
    widths 640 (fp32, within the 1e-5 gate) and 1088 (bf16), where d is
    tiled; the whole fused
    non-causal op also against the O(T^2) direct evaluation at BH 16, T
    1500 with padded keys;
12. small end-to-end references on the hubert SMOKE encoder in fp32: the
    card (kernels) against the same weights on the CPU (plain versions),
    the logits and the first layer's attention output, for rm (B3 + B4)
    and tensor_sketch (B6 + einsums); on the card, rm's two-launch path
    (``fuse_featurize="off"``: B1 + einsums) against its fused path;
13. the encoder slice: hubert-xlarge at full width and depth (48 layers),
    RM attention, random weights from a seed, bf16 compute, encoding 8
    clips x 1500 frames of seeded frame embeddings three times through
    ``train.steps.make_prefill_step`` (the first encode cold). Every
    encode must give finite logits and launch B3 and B4 48 times each and
    no other RM kernel; clip 3 encoded alone must give its batched logits
    within the bf16 budget; ``make_eval_step`` gives a finite CE within
    0.1 of its expected value at init; one encode of 1 x 32768 frames (the
    reference's prefill_32k length, its batch cut from 32 to 1) completes,
    and its first attention layer in fp32 on the card matches the plain
    path on the CPU;
14. where the encoder's time goes: a ``torch.profiler`` window over one
    warm 8 x 1500 encode;
15. kernels B7 (``ctr_feature_fused``) and B8 (``structured_feature_fused``)
    against their plain versions on the full qwen3-1.7b plans' weights
    (ctr: wr / wi ``[5, 127, 128]``; structured: d1 / d2 ``[5, 6, 128]``)
    at every row count their slices give them — the decode shape (x ``[64,
    128]``) and the prefill shape of each bucket (x ``[512 .. 4096, 128]``)
    — and a ragged count (70 rows), fp32 and bf16, each with two calls
    bitwise equal, its grid and the profiler's device time; B8 also at the
    hubert shape (one clip's 1500 frames x 16 heads, x at its true width 80
    of d_pad 128), and at the decode and bucket-256 rows through
    ``apply_structured_plan`` (the kept columns written straight into the
    map: bitwise the full width sliced by bucket; its device time beside
    the full-width, kept-columns and whole-map bounds); each family's
    ``registry.estimate_gram`` over ``[4096, 128]`` once, card against
    CPU; B8's split path past d_pad 8192 (an exp plan at D 4000 on 64 rows
    of d 9000, d_pad 16384, and of d 40000, d_pad 65536: fp32 and bf16
    against its plain version, two calls bitwise equal, in fp32 through
    ``apply_structured_plan`` bitwise the full width sliced, and at d 40000
    in 8 chunks of rows bitwise one chunk, with device, event and plain
    times beside its bound); both libraries' registers and spills, B7's
    tensor-core instructions and its tensor-core bound beside the
    CUDA-core one;
16. kernel B5 at the ragged width of the ctr features (F 255), at phase
    5's prefill shape, with phase 5's checks and times;
17. small end-to-end references for the two families: the qwen3 and
    hubert SMOKE models in fp32 with ``estimator="ctr"`` and
    ``"structured"``, the card against the CPU (logits; for qwen3 greedy
    tokens through the Scheduler, for hubert the first layer's attention
    output), with the launches each forward makes;
18. the ctr slice: qwen3-1.7b at full width and depth with
    ``estimator="ctr"``, phase 7's workload and checks through the
    two-launch path: B7 must launch twice a layer for every admission and
    decode step, B5 once a layer for every admission, no other RM kernel;
19. where the ctr slice's time goes, as in phase 8, with B7's and B5's
    device time in each window;
20. the structured slice: the same with ``estimator="structured"`` (B8 in
    place of B7);
21. where the structured slice's time goes, as in phase 8, with B8's and
    B5's device time in each window;
22. kernel B9 (``rm_feature_bucket``): its ``-Xptxas -v`` registers and
    spills and the tensor-core instructions of its library; then against
    its plain version, fp32 and bf16, at the bucket shapes of the paper's
    path: every bucket of Table 1's spambase map (poly10, d 57, D 500:
    counts 125 ... 1 at degrees 1-8) at its 1840-row test split, homog10
    at D 4000 (one bucket, degree 10, omega ``[40000, 50]``) at 100 and
    20000 rows, exp's deepest bucket at D 4000, a ragged 70 rows x count 1
    x degree 1, a Gaussian omega in fp32 (the remainder term of 3xTF32)
    on the tile and on a chain, and d 208 and 216 at degree 2 (the two
    sides of the tile's shared-memory limit); each case with the kernel
    and grid ``kernels.common.bucket_schedule`` chose, two calls bitwise
    equal, the profiler's device time, the CUDA-event time and both bounds
    (the tensor cores' and the fp32 CUDA cores'); at 20000 rows one
    profiler window read for where the CUDA-event time goes beyond the
    kernels' (``launch_gaps``); then the whole per-bucket path
    (``apply_feature_map_bucketed``: the map allocated once, one B9
    launch a bucket writing its columns in place) on the adult-shaped map
    (poly10, d 123, D 4000: 10 buckets and a const column) at 8000 rows,
    against the fused map (B1) on the card and the plain path on the CPU,
    with the device time of every kernel of the call beside fused B1's;
23. the paper's evaluation on the card, through ``repro_torch.paper``'s
    ``run()`` functions, ``repro_torch.core`` and ``repro_torch.data`` (the
    main path of this slice, its launch counts read around it): Figure 1
    (homog10, poly10 and exp at d 50, N 100, D 100 / 1000 / 4000; the
    error must shrink with D and the card's Gram equal the CPU's), one
    20000 x 20000 Gram of adult-shaped data at poly10 D 4000, the exact
    SVM's captured epochs bitwise the eager loop's on a 300-row Gram,
    Table 1 on nursery, spambase and ijcnn (the exact kernel SVM on 1200
    rows, one CUDA graph an epoch, its train wall beside the eager one;
    RM D 500 + ``train_linear``, H0/1 D 100 + ``train_linear``) and Figure
    2 (spambase, nursery, D 25 / 100 / 400, RF and H0/1), every row
    printed and each also run on the CPU from the same data and draws:
    the test predictions must agree; Table 1's per-bucket features (B9)
    must equal the fused ones (B1); Algorithm 2 (poly10 through
    Rademacher inner maps at d 123, D 4000 on x ``[20000, 123]``, one B9
    launch a bucket, against the CPU's plain path on 2000 rows; exp of
    RBF through RFF inner maps at d 50, D 1000 and 8000, its Gram error
    shrinking with D and the card's Gram equal to the CPU's); and Theorem
    12's required D;
24. training on the card (the serving and encoder engines freed before):
    (a) each differentiable attention op's gradients card against CPU in
    fp32 — B2 (``rm_attention_fused_causal``) at the prefill shape (BH 16,
    T 256, F 163, padded keys), B3 + B4 (``rm_attention_fused_noncausal``)
    at BH 16, T 1500, d = dv = 80 (padded keys), B5
    (``rm_attention_causal``) at phase 5's shape — each op's forward
    bitwise its forward-only wrappers' output with one launch of its
    kernels, no RM launch in the backward, q/k/v cotangents within 1e-4 x
    max(1, max |g_cpu|); (b) the qwen3 and hubert SMOKE models in fp32,
    card against CPU: every trainable leaf's ``loss_fn`` gradient within
    1e-4 x max(1, max |g|), and one ``make_train_step`` each (loss and
    grad_norm within 1e-4 relative); (c) qwen3-1.7b at full width and
    TRAIN_DEPTH (8) of its 28 layers (``dataclasses.replace``; bf16
    compute, fp32 masters, AdamW) trained 8 steps through
    ``train.trainer.Trainer`` on ``SyntheticLMDataset`` (4 x 256 tokens a
    step, vocab 151936), the first step cold: every step finite, B2
    exactly 16 launches (8 forward, 8 in the remat recompute:
    ``ModelConfig.remat``, on by default) and no other RM kernel, the last
    step's CE
    below the first's, the final checkpoint restored bitwise; the cold and
    warm step walls, tokens/s, peak device memory beside the train state's
    bytes, and one profiled warm step (wall, device busy and idle share,
    device kernels, the largest device consumers, B2's device time beside
    its backward's recompute, and both alone at the step's shape); (d) one
    ``make_train_step`` of hubert-xlarge at full width and depth (48
    layers, 2 clips x 1500 frames, framewise targets from the seed):
    finite, B3 and B4 96 launches each (48 forward, 48 recompute), its
    wall and peak memory;
25. observability, restart recovery and exact attention: (a) phase 7's
    workload served again by a ``Scheduler(obs=Obs(trace_path=...,
    install_kernel_tracing=True))`` (the trace under ``smoke_out/
    phase25/``, git-ignored): every request finishes with phase 7's
    tokens bit for bit, the trace's meta header carries the port's
    provenance, each request's events run submit -> admit -> finish,
    there are exactly 28 ``kernel/rm_attn_fused`` spans an admission and
    28 ``kernel/rm_feature`` spans a decode step, equal to B2's and B1's
    launch counters, each with its analytic flops and hbm_bytes; then the
    warm decode-step wall with obs and without (the same engine, printed
    side by side) and the synchronizing calls of a decode tick with and
    without, which must be equal; (b) the drift check for rm at qwen3's
    head (d 128, D 256) on the card: ``ok`` at the deployed budget, its
    sup error within 1e-5 of the CPU's on the same map, and firing at a
    budget cut to 1/16 held to twice the deployed map's sup error; one B1
    launch a check; (c) restart recovery: the same engine with one
    injected decode failure and ``max_restarts=1`` finishes every request
    with phase 7's tokens, and with ``max_restarts=0`` the failure
    propagates; (d) exact attention: the qwen3 SMOKE model in fp32 card
    against CPU (logits within 1e-4 relative, greedy tokens identical, no
    RM launch) and one exact ``make_train_step`` (loss and grad_norm
    within 1e-4 relative); a 4096-token causal prompt through the
    blockwise path against the small one in fp32 (within 1e-4 x max(1,
    max |small|)); qwen3-1.7b exact at full width and depth on phase 7's
    workload (every request finishes, no RM launch, requests 7 and 1
    alone give their batched tokens) and its warm decode-step wall beside
    rm's; (e) hubert-xlarge exact at full width and depth, 8 x 1500
    frames: finite logits, its wall beside phase 13's rm wall, its peak
    memory;
26. adaptive accuracy, then MLA and MoE: (a) a growable map
    (``core.doubling``: exp at d 64, 256 features a generation) grown G
    1 -> 2 -> 4 -> 8 on the card: the raw prefix bitwise equal across each
    growth, 1 -> 4 equal to 1 -> 2 -> 4, one B1 launch a generation, the
    same draws on the CPU within 1e-5, ``estimate_gram`` within 1e-5 of
    the concatenation's Gram; the drift loop: the G 8 map's sup error sets
    an envelope of twice it, a map at D/16 is checked, grown
    (``recommend()`` -> ``grow_to``) and rebound until it is inside, each
    bound tighter than the last, one B1 launch a generation a check; (b)
    every family's fused featurize timed on the card (CUDA events, packed
    weights, fp32 and bf16) at ``BENCH_core.json``'s three shapes, written
    in that file's schema (``"backend": "gpu"``) to
    ``smoke_out/phase26/bench_core_gpu.json``; the ``CostModel`` fitted
    from it covers the 4 x 2 grid, ``select_budget`` at (0.25, 0.05) and
    (0.1, 0.01) certifies each eps, a ``"tpu"`` platform pin is refused,
    and ``launch/serve.py --smoke --eps 1.0 --delta 0.1 --bench <it>``
    resizes ``cfg.rm`` and serves; (c) qwen3-1.7b rm with
    ``accuracy_tiers={"low": 1, "standard": 2, "high": 4}`` on phase 7's
    workload: tokens bitwise phase 7's, each request's ``tier_features``
    its tier's prefix, B2 28 a prefill and B1 28 a decode step; (d)
    deepseek-v2-lite-16b: its SMOKE config in fp32 card vs CPU in rm fused
    (B2), rm two-launch (B1 + B5) and exact (no RM kernel) mode, logits
    within 1e-4 relative and greedy tokens identical; B2 at its
    bucket-256 prefill (16 heads, q/k width 192, values 128) and B1 at
    its decode shape (x ``[128, 192]``) against their plain versions (fp32
    within the 1e-5 gate, bf16, two calls bitwise equal, times and
    bounds); then the full-width model (27 layers, the first dense, MLA,
    64 routed experts top-6 + 2 shared; bf16 weights drawn on the card
    from seed 0) serving phase 7's workload (its lengths, token ids from
    deepseek's vocabulary) through the Scheduler: every request finishes,
    B2 27 launches a prefill and B1 27 a decode step; parameters, decode
    state and peak memory, and phase 8's warm run and profiler windows.
    No request is held alone against batched: the MoE capacity counts
    every token of a call;
27. the SSM mixers and the last configs: (a) SMOKE card vs CPU in fp32
    (logits within 1e-4 relative, greedy tokens of 4 requests identical,
    the forward's launches): jamba in rm fused (B2), rm two-launch (B1 +
    B5) and exact mode, xlstm (no RM kernel), and olmo, danube, qwen2 and
    internvl2 in rm fused (internvl2 with 6 precomputed patch embeddings
    before the tokens); (b) B2 at jamba's exact-length prefills (32 heads
    over 8 kv heads, d 128, F 163, T 5, 37 and 200: SSM prompts are not
    bucketed) and B1 at its decode shape (x ``[256, 128]``) against their
    plain versions (fp32 within the 1e-5 gate, bf16, two calls bitwise
    equal, times and bounds); (c) jamba-v0.1-52b at full width (d_model
    4096, 32 / 8 heads of 128, d_ff 14336, 16 experts top-2, Mamba d_state
    16 expand 2, vocab 65536) with its depth cut from 32 to 8 layers (one
    period: 32 layers are about 96 GiB in bf16, one period about 25),
    bf16 weights drawn on the card from seed 0, rm, serving phase 7's
    workload at each prompt's own length (ids from jamba's vocabulary):
    every request finishes, B2 launches once a prefill and B1 once a
    decode step; parameters, decode state, peak memory, TTFT, tokens/s
    and phase 8's warm run and profiler windows (the prefill window at T
    200); (d) xlstm-350m at full width and depth (24 layers) on the same
    workload (ids under 50304): every request finishes, no RM kernel
    launches; its mLSTM decode state's bytes and the same windows;
28. meshes (``repro_torch.distributed``, ``launch.mesh``): (a) the
    adult-shaped map of phase 23 (poly10, d 123, D 4000) through
    ``make_feature_map(num_shards=4)``, the host loop on x ``[20000,
    123]``: B1 4 launches an apply, the first 2048 rows' features and Gram
    against the same draws on the CPU (1e-5, 1e-4 relative), the apply's
    event and device time beside one unsharded D 4000 B1 call's; the
    tensor_sketch, ctr and structured maps (exp, D 1024) as 4 shards on x
    ``[64, 128]``: B6, B7, B8 4 launches each, card vs CPU; (b) an NCCL
    world of one (``init_distributed``) and its ``make_feature_mesh()``:
    the mesh apply bitwise the host loop, one B1 launch, one
    ``all_reduce`` a Gram within 1e-5 of the host loop's; (c) two spawned
    processes joined by gloo on cuda:0, each drawing and featurizing its
    own shard (one B1 launch): the gathered features on x ``[4096, 123]``
    bitwise the host loop of 2 shards, their Gram (one ``all_reduce``)
    within 1e-5 of it; (d) qwen3-1.7b rm at full width and depth (phase 24
    c's 4 x 256 tokens, bf16 compute) 3 steps through the ``Trainer`` with
    ``mesh=None``, on ``make_host_mesh()`` (losses bitwise ``mesh=None``'s)
    and with ``grad_compression="int8_pod"`` on a (1, 1, 1) ``("pod",
    "data", "model")`` mesh: B2 56 launches a step, finite losses, the
    residuals' max, each run's wall and peak memory beside phase 24 c's.
29. tensor parallelism over "model" and data-parallel serving, each part
    2 spawned processes joined by gloo on cuda:0 (NCCL refuses two ranks
    on one card): (a) qwen3-1.7b rm at phase 24 c's shape, 3 steps on a
    (data 1, model 2) mesh in bf16 and in fp32 compute, each against one
    device's run: each rank 8 heads, B2 56 a step, its all-reduces over
    "model" a step; in fp32 the losses and every ``grad_norm`` within
    TP_FP32_TOL, in bf16 the losses and the first ``grad_norm`` (where
    both hold the same weights) within the bf16 budget, the later ones
    printed (ROADMAP.md queue C, measured gaps: a head near its rm clamp);
    for each dtype the gradient leaves that part most at the third step's
    state and layer 15's smallest |rm denominator| there on one device
    and on each rank (``clamp_probe``); step walls and peak memory beside
    phase 24 c's; the mesh runs with ``"act_seq"`` on, the default; (b)
    phase 7's workload through ``Scheduler(mesh=)``, the weights whole
    over "data" (``rules={"fsdp": None}``; phase 31 c serves them cut), on
    (2, 1), tokens
    bitwise one device's serving with the rank's 2 lanes, and on (1, 2),
    where a request that
    parts from phase 7's tokens must part inside the bf16 noise (the rows
    it was sampled from within the budget, the two tokens within twice
    their gap); B1 / B2 launches and peak memory a rank; (c) deepseek-v2-
    lite-16b rm drawn by ``make_engine(mesh=)`` (bf16 weights, each rank's
    shards cut block by block as drawn) prefilling 4 x 256 tokens on (1,
    2): logits by position and greedy agreement against one rank's,
    printed (the MoE's routing is discontinuous), its first MoE layer
    through ``apply_moe(mesh=)`` on one input within the bf16 budget, and
    its first 4 layers (dense, then 3 MoE) in fp32 within E2E_TOL at
    every logit, B2 27 and 4 a rank; (d) hubert-xlarge rm in fp32
    encoding 2 x 1500 frames on (1, 2): B3 and B4 48 a rank, within
    E2E_TOL.
30. SSM tensor parallelism, FSDP and "act_seq", in one spawn of 2 gloo
    processes on cuda:0 after the one-device runs: (a) jamba-v0.1-52b rm
    at full width, one pattern period (8 layers), drawn by
    ``make_engine(mesh=)`` on (data 1, model 2): in fp32 the prefill
    logits of a 40-token prompt (``"act_seq"`` cuts it) within E2E_TOL of
    one device's and the greedy tokens of three prompts beside one
    device's (printed, with where they part); in bf16 weights phase 27
    c's requests with B2 once a prefill and B1 once a decode step on each
    rank, a decode step's wall, and a rank's peak beside phase 27 c's;
    (b) xlstm-350m at full width in fp32, XLSTM_TP_DEPTH (8) of its 24
    layers (two pattern periods): 3 training steps of 4
    x 128 tokens on (1, 2), losses and ``grad_norm`` within TP_FP32_TOL
    of one device's, then three prompts' greedy tokens; (c) qwen3-1.7b rm
    at phase 24 c's shape: 3 fp32 steps with FSDP on (2, 1) against phase
    29 a's one-device fp32 run (within TP_FP32_TOL), B2 56 a step a rank,
    a rank's train state under 0.6 of one device's and its peak beside
    phase 24 c's; then 3 bf16 steps on (1, 2) with ``"act_seq"`` off
    (the replicated path), a rank's peak beside phase 29 a's with it on.
31. activation checkpointing, the dry run against the card, and serving
    weights cut over "data": (a) qwen3-1.7b rm at phase 24 c's shape, 3
    bf16 steps with ``remat`` on and 3 off (``tp_train_run`` on one
    device): losses bitwise equal (else the gap is printed and an fp32
    pair held within REMAT_LOSS_TOL), B2 56 a step on and 28 off, both
    peaks beside 36.80 GiB (the step's before remat) and both warm step
    walls; hubert's remat step is phase 24 d's (B3 and B4 96, its peak
    beside 45.84 GiB); (b) the dry run (``launch.dryrun.measure`` on a
    one-rank fake mesh, run after (a)'s timings) of (a)'s two steps and
    of phase 7's decode step (4 slots, max_len 256): the predicted train
    state's and fp32 weights' bytes equal the card's exactly; each
    predicted peak (arguments + temp) beside the card's, with the error;
    the counted FLOPs and ``model_flops`` over (a)'s warm wall as TFLOP/s
    and a share of 989; (c) phase 7's first CUT_SERVE_REQUESTS requests through
    ``make_engine(mesh=)`` on (data 2, model 1), 2 gloo processes on
    cuda:0, with the weights cut over "data" and with ``rules={"fsdp":
    None}``: tokens bitwise equal between the two and across the ranks,
    B1 28 a decode step and B2 28 an owned admission a rank (56 over
    the ranks for the 2 admissions, as in phase 29 b's (2, 1) serve), a
    rank's fp32 masters under 0.6 of the whole weights', its peak and a
    decode step's wall printed.
32. the deprecated bucketed engine and the SMOKE-only configs at full
    width: (a) qwen3 SMOKE rm in fp32 through ``ServingEngine`` on the
    card and the CPU, greedy tokens of 5 requests identical, B2 once a
    layer a prefill and B1 once a layer a decode iteration; qwen3-1.7b at
    full width through ``make_engine(scheduler="bucketed")`` on phase 7's
    workload, its B2 / B1 launches checked and its tokens' agreement with
    phase 7's Scheduler printed (bf16, not gated); (b) olmo-1b,
    h2o-danube-3-4b (sliding window 4096, which rm mode does not use),
    qwen2-7b (QKV bias) and internvl2-1b (its vision_stub served on
    tokens, as the reference's executor serves it) at full width and
    depth, and mixtral-8x7b at full width with MIXTRAL_DEPTH of its 32
    layers (``dataclasses.replace``; its 93 GB do not fit one card), each
    in rm mode with bf16 weights drawn on the card on phase 7's workload:
    first B2 at the model's bucket-256 prefill shape (its heads and head
    width, 56 keys padded) and B1 at its decode shape (2 x 4 lanes x its
    heads) against their plain versions, fp32 and bf16, on a feature plan
    drawn for the model's head width (``h2o`` 120, ``internvl2`` 64, the
    rest 128), timed with CUDA events (no profiler window); then B2 once a layer a prefill and B1 once a layer a
    decode step, peak
    memory beside the weights' bytes, TTFT and tokens/s cold and warm, and
    one profiler window of a decode step and one of the bucket-256
    prefill (wall, busy, idle, kernels, largest consumers).
33. the dry run's last three levers as sharding rules the model reads,
    in one spawn of 2 gloo processes on cuda:0 after the one-device runs:
    (a) ``kv_seq_shard`` (``{"kv_seq": "model", "kv_heads": None}``) on
    (data 1, model 2): qwen3 SMOKE exact fp32 greedy tokens bitwise one
    device's; qwen3-1.7b exact at full width and depth through
    ``make_engine(mesh=)`` on phase 7's workload in bf16 (tokens, where
    they part from one device's and the rows' gaps printed: the mesh's
    bf16 rows part from one device's before the lever acts), held against
    the control, the same mesh with the cache cut by kv head (the default
    rules) on the LEVER_CONTROL_REQUESTS longest requests: every row whose
    inputs agree within one device's own bf16-against-fp32 gap on those
    requests (the reading, printed beside the 3e-2 bf16 budget); and the
    split-K in fp32 on the LEVER_FP32_REQUESTS longest requests, whose
    decode steps read both ranks' slots (tokens bitwise, every row within
    E2E_TOL); a rank's k at half the sequence with every kv head, its
    cache bytes beside the head cut's, a decode step's wall and device
    busy; (b) ``vocab_unsharded``: 3 fp32 steps of qwen3-1.7b rm at
    TRAIN_DEPTH layers, 4 x 256 tokens on (1, 2), losses within
    LEVER_LOSS_TOL of the same run with the vocabulary cut, B2 16 a step
    a rank, both peaks; (c) ``sp_data``: 3 fp32 steps at batch 1 x 256 on
    (2, 1) at SP_DEPTH layers, losses and ``grad_norm`` within
    TP_FP32_TOL of one device's, a rank's peak beside one step without
    the rule.

Before phase 2 the card runs a second of fp32 products, so the first
timed kernel does not meet idle clocks. It then prints one ``{"kernels":
[...]}`` line (``ms``: CUDA events over repeated launches through the
wrapper, for every kernel but B6, B7 and B8, whose ``ms`` is the
profiler's device time of the kernel itself; B1, B2, B5 and B9 carry
that device time beside as ``device_ms``; bounds computed from this run's
shapes, launches from the slice that runs each kernel — for B9 the paper
phase 23, its per-bucket featurizes and Algorithm 2's buckets; the host time of one call through each wrapper is printed
beside its check; every ``bound_ms`` but B8's is on the tensor
cores, where they run their products, and they also carry the bound on
the fp32 CUDA cores and their grids; B1 its Gram-shape and adult-map
times and its device time in the decode step, B2 its 4096-token, wide-F
and 32768-token times, the device memory of a call, and its device time
in the bucket-256 prefill, B3 and B4 the 1 x 32768 shape's times, B5 its
device time in each two-launch bucket-256 prefill, B6 to B8 theirs in the
decode step and that prefill, B8 its times through
``apply_structured_plan`` beside the kept-columns and whole-map bounds
and its split path's at d_pad 16384 and 65536,
B9 its grid and the adult map's per-bucket device time beside fused
B1's; B2, B3 and B4 their launches per train step, B2 its device time and
its backward's in the profiled qwen3 train step; B1 and B2 their launches
in phase 25's traced serve, B1 the drift check's; B1 and B2 with
``deepseek_*`` keys: their times at the MLA width, their launches in
deepseek's serve and their device time in its windows; B1 and B2 with
``jamba_*`` keys: B2's times at T 5, 37 and 200 (``jamba_t5_*`` ...), B1's
at jamba's decode shape, their launches in jamba's serve and their device
time in its windows; B1 and B2 with ``olmo_*``, ``h2o_*``, ``qwen2_*``,
``internvl2_*`` and ``mixtral_*`` keys: their times at those models'
bucket-256 prefill and decode shapes (phase 32); B1 and B6–B8 their
launches in a 4-shard apply
(``sharded_launches``), B1 that apply's event and device times; B2 its
training peak (``train_peak_gib``) and its launches in phase 28's
data-parallel runs; B1–B4 their launches a rank in phase 29's tensor- and
data-parallel runs (``tp_*``, ``dp_*``), B2 a rank's training peak and
layer 15's smallest |rm denominator| (``clamp_min_den_*``); B1 and B2
their launches a rank in phase 30's jamba serve (``tp_jamba_*``), B1 its
decode-step wall there, B2 a rank's peak there, its launches a step and a
rank's peak and train state under FSDP (``fsdp_*``), a rank's peak
with ``"act_seq"`` off (``seq_off_*``) and its launches a step a rank
under phase 33's levers (``vocab_unsharded_*``, ``sp_data_*``)) and, as
its last
line, ``{"ok": true, "device": {...}}``. Without a CUDA device it prints
no result and exits non-zero. Should the run near its time limit, the rm
slice's warm repeat (phase 8) is the part to cut first, then the
tensor_sketch slice's (phase 10), then phase 24's profiled warm step and
its timings alone, then phase 25's exact hubert encode (e) and its warm
exact decode timing, then phase 26's deepseek profiler windows, then phase
27's jamba and xlstm profiler windows, then phase 30's xlstm tokens, then
phase 32's profiler windows; no kernel check and no gradient check is cut.
Already cut for time: phase 24 c's depth (TRAIN_DEPTH), phase 30 b's
(XLSTM_TP_DEPTH), phase 31 c's requests (CUT_SERVE_REQUESTS, 2) and
phase 33 a's control and fp32 requests (LEVER_CONTROL_REQUESTS, 4;
LEVER_FP32_REQUESTS, 2) and phase 33 c's depth (SP_DEPTH, 4).
"""
import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM published peaks (dense): HBM bytes/s, fp32 (CUDA cores) and
# bf16 (tensor cores) operations/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
# TF32 on the tensor cores (dense). An fp32-accurate product there takes
# three TF32 mma (3xTF32), or two where one operand is a TF32 number
# already (its low part is 0).
PEAK_TF32_OPS_PER_S = 495e12

VALID_REASONS = {"eos", "max_new_tokens", "cache_full"}
B1_TOL = 1e-5   # x max(1, max |plain|): fp32 sums of <= 10 x 128 products
#                 (3xTF32 on fp32 inputs, exact bf16 products in fp32)
B2_TOL = 1e-4   # x max(1, max |plain|): fp32 sums of up to T x F terms
# B2's out, S and n on fp32 inputs, x max(1, max |plain|): the precision of
# its 3xTF32 products (as B34_FP32_TOL for B3 and B4)
B2_FP32_TOL = 1e-5
B6_TOL = 1e-5   # x max(1, max |plain|): fp32 sums of <= 128 and <= c terms
B6_GRAM_TOL = 1e-4   # x max(1, max |plain|): Gram sums 256 such features
B7_TOL = 1e-5   # x max(1, max |plain|): fp32 sums of <= 5 x 128 products
B8_TOL = 1e-5   # x max(1, max |plain|): products of 128-term butterflies
FEATURE_GRAM_TOL = 1e-4  # x max(1, max |plain|): Gram sums of 255 features
B9_TOL = 1e-5   # x max(1, max |plain|): fp32 sums of <= 123 products, then
#                 a product of <= 11 such sums in the same order j = 0, 1, ...
BUCKETED_TOL = 1e-5  # x max(1, max |fused|): B9's buckets against B1's map
FIG1_TOL = 1e-4      # x max(1, max |plain|): card Gram against the CPU's
TABLE1_FLIP_SHARE = 0.005   # test predictions the card may flip vs the CPU
B5_TOL = 1e-4   # x max(1, max |plain|): fp32 sums of up to C x F terms
# B5's pass B on fp32 features against its plain version in float64, x
# max(1, max |plain|): the precision of its 3xTF32 products (as
# B34_FP32_TOL); a product in plain TF32 fails it (PERF.md)
B5_FP32_TOL = 1e-5
E2E_TOL = 1e-4  # relative logits gap of two fp32 paths of one model
B3_TOL = 1e-4   # x max(1, max |plain|): fp32 sums of up to T terms (S, n)
B4_TOL = 1e-4   # x max(1, max |plain|): fp32 sums of F terms, then a divide
# B3's S, n and B4's out on fp32 inputs, x max(1, max |plain|): the
# precision of their 3xTF32 products. 3xTF32 reads 2e-6 (S, the encode) to
# 7e-6 (S, 1 x 32768); a dropped 3xTF32 term fails this where it may still
# pass B3_TOL / B4_TOL (PERF.md, the 3xTF32 gate).
B34_FP32_TOL = 1e-5
BF16_LOGITS_TOL = 3e-2  # relative gap of two bf16 encodes (ROADMAP queue C)
ENC_CLIPS, ENC_FRAMES = 8, 1500   # 30 s of 20 ms frames: the ASR window
LONG_FRAMES = 32768               # the reference's prefill_32k length


def time_ms(torch, fn, iters=50, warmup=5):
    """Mean device time per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, iters=200):
    """Host time per call to enqueue ``fn`` (Python, argument checks and
    the launch itself), in microseconds: the host clock around ``iters``
    calls, with the device drained before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def warm_card(torch, seconds=1.0):
    """Keep the card busy with fp32 products for ``seconds``, so the first
    timed kernel does not run at idle clocks (the build leaves the card
    idle for several seconds); return the SM clock nvidia-smi reads then."""
    a = torch.randn((4096, 4096), device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a = (a @ a).clamp_(-1.0, 1.0)
        torch.cuda.synchronize()
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def bound(bytes_moved, ops, dtype_name):
    """The least time the card could take: max(bytes / HBM rate, ops /
    peak rate of the input type), in ms, and which of the two it is."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def omega_bytes(col_deg, d, item):
    """Bytes of the omega rows the map reads: one d-long row per degree
    slot a column uses (the zero rows that pad a column past its degree
    feed no output)."""
    return int(col_deg.sum()) * d * item


def worst(checks):
    """The check closest to its limit: ``(label, err, tol)`` of the largest
    err / tol among ``checks`` of ``(label, err, tol)``."""
    return max(checks, key=lambda c: c[1] / c[2])


def featurize_ops(rows, col_deg, d):
    """Operations of the RM map on ``rows`` inputs: one d-long dot product
    per degree slot a column uses, the running product, the scale."""
    import numpy as np

    s = int(col_deg.sum())
    muls = int(np.maximum(col_deg.astype(np.int64) - 1, 0).sum())
    return rows * (2 * d * s + muls + len(col_deg))


def sketch_cost(rows, plan, item):
    """(bytes, stage-1 operations, stage-2 operations) of kernel B6 on
    ``rows`` inputs, counted as this plan's data needs them: the omega rows
    the columns use (the sum of the column degrees, real and imaginary),
    the block-diagonal inverse DFT (sum of c^2 entries, real and
    imaginary), x once and the output once; per row a complex d-long dot
    product for every used slot and the complex running product (stage 1),
    the block inverse DFT and the scale (stage 2)."""
    import numpy as np

    deg = plan.column_degrees()
    d = plan.input_dim
    fs = plan.num_sketch_cols
    used = int(deg.sum())
    diag = int(sum(c * c for c in plan.counts))
    muls = int(np.maximum(deg.astype(np.int64) - 1, 0).sum())
    nbytes = (rows * d * item + 2 * used * d * item + 2 * diag * item
              + fs * 8 + rows * fs * 4)
    return nbytes, rows * (4 * d * used + 6 * muls), rows * (4 * diag + fs)


def ctr_cost(rows, plan, item):
    """(bytes, operations) of kernel B7 on ``rows`` inputs, counted as this
    plan's data needs them: x once, the wr and wi rows the columns use (the
    sum of the column degrees), the column vectors, the ``[rows, 2 Fc]``
    output once; per row a real and an imaginary d-long dot product for
    every used slot, the complex running product and the two scales."""
    import numpy as np

    deg = plan.column_degrees()
    d = plan.input_dim
    fc = plan.num_complex
    used = int(deg.sum())
    muls = int(np.maximum(deg.astype(np.int64) - 1, 0).sum())
    nbytes = rows * d * item + 2 * used * d * item + fc * 8 + rows * 2 * fc * 4
    return nbytes, rows * (4 * d * used + 6 * muls + 2 * fc)


def structured_cost(rows, plan, item, kept=False):
    """(bytes, operations) of kernel B8 on ``rows`` inputs of the plan's
    true width d: x once, the d1 and d2 rows the stacks use (one per stack
    and slot of its degree), the column vectors, and the output once: the
    ``[rows, S d_pad]`` full width (surplus columns included: they are
    outputs of the function), or where ``kept`` only the ``[rows,
    num_random_cols]`` kept columns that ``apply_structured_plan`` has it
    write; per row, stack and used slot the two sign products, the d_pad
    log2(d_pad) butterfly adds and the running product, and the scale per
    column."""
    d, m = plan.input_dim, plan.d_pad
    cols = plan.padded_num_cols
    out_cols = plan.num_random_cols if kept else cols
    slots = plan.total_slots
    nbytes = (rows * d * item + 2 * slots * m * item + cols * 8
              + rows * out_cols * 4)
    lg = m.bit_length() - 1
    return nbytes, rows * (slots * m * (lg + 3) + cols)


def bucket_cost(rows, count, degree, d, item):
    """(bytes, operations) of kernel B9 on ``rows`` inputs: x and the
    ``count * degree`` omega rows read once, the ``[rows, count]`` output
    written once; per row and feature ``degree`` d-long dot products, the
    running product and the scale."""
    nbytes = rows * d * item + count * degree * d * item + rows * count * 4
    return nbytes, rows * count * (2 * d * degree + degree)


def chunked_cost(bh, t, f, dv, chunk, item):
    """(bytes, operations) of kernel B5: zq, zk, v, the prefixes and the
    output once each; per chunk the causal triangle of scores over F, the
    triangle times v, zq S_prev and zq n_prev over F, the row sums and the
    divide."""
    n = t // chunk
    pairs = chunk * (chunk + 1) // 2
    nbytes = (2 * bh * t * f * item + bh * t * dv * 4 + bh * n * f * dv * 4
              + bh * n * f * 4 + bh * t * dv * 4)
    per_chunk = (2 * pairs * f + 2 * pairs * dv + 2 * chunk * f * dv
                 + 2 * chunk * f + pairs + chunk * dv)
    return nbytes, bh * n * per_chunk


def state_cost(bh, t, valid, d, dv, col_deg, item):
    """(bytes, featurize operations, state operations) of kernel B3: k, v,
    kvalid, the omega rows the plan uses and the column vectors read once,
    S and n written once; per real key (``valid`` of the ``bh * t`` keys:
    a padded key needs no work) the featurize and the mask, then one row of
    S (2 F dv) and of n."""
    f = len(col_deg)
    nbytes = (bh * t * d * item + bh * t * dv * 4 + bh * t * 4
              + omega_bytes(col_deg, d, item) + f * 8 + bh * f * dv * 4
              + bh * f * 4)
    return (nbytes, featurize_ops(valid, col_deg, d) + valid * f,
            valid * f * (2 * dv + 1))


def apply_cost(bh, t, d, dv, col_deg, item):
    """(bytes, featurize operations, output operations) of kernel B4: q,
    S, n, the omega rows and the column vectors read once, the output
    written once; per query row the featurize, then ``zq S`` (2 F dv),
    ``zq n`` (2 F) and the divide."""
    f = len(col_deg)
    nbytes = (bh * t * d * item + bh * f * dv * 4 + bh * f * 4
              + omega_bytes(col_deg, d, item) + f * 8 + bh * t * dv * 4)
    return (nbytes, featurize_ops(bh * t, col_deg, d),
            bh * t * (2 * f * dv + 2 * f + dv))


def tensor_core_bound(nbytes, feat_ops, other_ops, dtype_name, exact_w):
    """A featurizing kernel's bound on the tensor cores (B1-B4, B6, B7):
    ``(ms, "bytes" or "operations")``, max(bytes / HBM rate, the featurize
    at the rate of the mma terms its products take plus the contraction
    that follows, B6's inverse DFT or B3 / B4's, in 3xTF32). fp32 rows
    take 3xTF32, or two TF32 terms where the weights are TF32 numbers
    (``exact_w``: the rm plans' omegas, the ctr plans' {0, +-1}); bf16 rows
    one bf16 mma."""
    if dtype_name == "float32":
        feat_rate = PEAK_TF32_OPS_PER_S / (2 if exact_w else 3)
    else:
        feat_rate = PEAK_OPS_PER_S["bfloat16"]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (feat_ops / feat_rate + other_ops / (PEAK_TF32_OPS_PER_S / 3)) \
        * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def first_attention(torch, params, cfg, batch):
    """The first layer's attention output ``[B, T, d_model]`` of the model
    on ``batch``: the inputs as ``forward`` prepares them, the first norm,
    then ``attention_forward``."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer as tt
    from repro_torch.models.layers import apply_norm

    cp = tt.cast_params_to_compute(params, cfg)
    x, positions = tt._prepare_inputs(cp, cfg, batch)
    layer = cp["layers"][0]
    with torch.inference_mode():
        return attn_mod.attention_forward(
            layer["attn"], cfg, apply_norm(layer["norm1"], cfg, x),
            positions)


def run_workload(torch, engine, prompts, base):
    """Submit every prompt as a greedy 16-token request (ids ``base + i``),
    step until drained; return (finished states, admissions, decode steps,
    wall seconds)."""
    from repro_torch.serve import Request

    for rid, prompt in prompts.items():
        engine.submit(Request(base + rid, prompt, max_new_tokens=16))
    torch.cuda.synchronize()
    admissions = decode_steps = 0
    t0 = time.perf_counter()
    while engine.pending():
        info = engine.step()
        admissions += len(info.admitted)
        decode_steps += info.active > 0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = {rid: engine.finished[base + rid] for rid in prompts}
    return done, admissions, decode_steps, wall


def device_profile(torch, fn):
    """Run ``fn`` once under torch.profiler; return (device busy ms, {kernel
    name: ms}, device kernels, host ms inside profiled operators) — the
    device numbers from the CUDA kernel events (one stream, so their
    durations add up to the busy time), the host number the sum of the CPU
    events' self times (PyTorch operators and CUDA runtime calls; the
    Python between them is not in it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    count = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            count += 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    ops_ms = sum(e.self_cpu_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CPU) / 1e3
    return sum(by_name.values()), by_name, count, ops_ms


def kernel_device_ms(torch, fn, kernel, iters=50):
    """Device time per call of the CUDA kernels whose names contain
    ``kernel`` (a string, or a tuple of strings any of which may match),
    from the profiler's kernel events over ``iters`` calls of ``fn`` (after
    a warm-up): the kernels' own time even where the host enqueues a call
    more slowly than the card runs it, which a CUDA-event window over
    back-to-back calls would measure instead. The profiler may keep fewer
    kernel events than were launched (48 of 50 in one window, PERF.md):
    the time is the mean of the events it kept times
    the events a call launches (the kept ones over ``iters``, rounded), and
    a window that kept fewer is reported."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    for _ in range(5):
        fn()
    # the profiler has returned a window without the kernel's events once
    # in several runs (the same case saw them in the other runs): a window
    # that lost them is taken again, twice at most
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        found = [e.time_range.elapsed_us() for e in dev
                 if any(k in e.name for k in names)]
        if found:
            per_call = max(1, round(len(found) / iters))
            if len(found) != per_call * iters:
                print(f"[profile] the window kept {len(found)} of "
                      f"{per_call * iters} {kernel} kernel events; their "
                      "mean stands for the lost ones")
            return sum(found) / len(found) * per_call / 1e3
        print(f"[profile] a window of {iters} calls showed no {kernel} "
              f"event ({len(dev)} device events in all); taking it again")
    raise AssertionError(f"the profiler saw no {kernel} launch")


def launch_gaps(torch, fn, kernel, iters=50):
    """Where a CUDA-event window over back-to-back calls of ``fn`` spends
    the time that is not the kernels' own: one ``torch.profiler`` window
    over ``iters`` calls (after half a second of warm calls), read for the
    window's CUDA-event time per call, the kernel events it kept (names
    containing ``kernel``) against the ``iters`` launches made, their
    device time per call, every other device activity, the gaps between
    consecutive kernel events and the host's operators that ran inside the
    largest of them, beside the SM clock and power that ``nvidia-smi``
    sampled every 20 ms during the window. Returns those as a dict."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.5:
            fn()
            torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        samples = smi.communicate(timeout=30)[0]
    clocks = []
    for ln in samples.splitlines():
        parts = [p.strip() for p in ln.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            clocks.append((int(parts[0]), float(parts[1])))
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    ks = [e for e in dev if kernel in e.name]
    others = {}
    for e in dev:
        if kernel not in e.name:
            n, us = others.get(e.name, (0, 0.0))
            others[e.name] = (n + 1, us + e.time_range.elapsed_us())
    gaps = [b.time_range.start - a.time_range.end for a, b in zip(ks, ks[1:])]
    in_gap = {}
    if gaps:
        i = max(range(len(gaps)), key=gaps.__getitem__)
        lo, hi = ks[i].time_range.end, ks[i + 1].time_range.start
        for e in prof.events():
            if (e.device_type == DeviceType.CPU and e.cpu_parent is None
                    and lo <= e.time_range.start < hi):
                n, us = in_gap.get(e.name, (0, 0.0))
                in_gap[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return dict(
        events_ms=start.elapsed_time(end) / iters, launches=iters,
        kernel_events=len(ks),
        kernel_device_ms=sum(e.time_range.elapsed_us() for e in ks)
        / 1e3 / max(len(ks), 1),
        span_ms=((ks[-1].time_range.end - ks[0].time_range.start) / 1e3
                 if ks else 0.0),
        gap_us_mean=sum(gaps) / len(gaps) if gaps else 0.0,
        gap_us_max=max(gaps) if gaps else 0.0,
        other_device={k: (n, round(us / 1e3, 4))
                      for k, (n, us) in others.items()},
        host_in_largest_gap={k[:60]: (n, round(us, 1))
                             for k, (n, us) in in_gap.items()},
        sm_clock_mhz=[c for c, _ in clocks], power_w=[p for _, p in clocks])


def count_syncs(torch, fn):
    """Synchronizing calls ``fn`` makes, as PyTorch's sync debug mode
    reports them (a prototype that does not see every kind)."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def unit_rows(torch, shape, gen):
    x = torch.randn(shape, generator=gen, device="cuda")
    return x / x.norm(dim=-1, keepdim=True)


def rel_err(torch, got, want):
    return ((got.cpu() - want.cpu()).abs().max()
            / want.abs().max().clamp_min(1.0)).item()


def serve_slice(torch, tag, engine, cfg, prompts, counters, expected):
    """Drive the slice once with every launch counter at 0; check that each
    request finished with valid tokens, that ``expected(admissions, decode
    steps)`` gives each counter's launches, and that requests 7 and 1 run
    alone give their batched tokens. Returns (finished states, launches
    by kernel)."""
    from repro_torch.serve import Request

    buckets = sorted({engine.executor.bucket_for(len(p))
                      for p in prompts.values()})
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    done, admissions, decode_steps, wall = run_workload(torch, engine,
                                                        prompts, 0)
    launches = {kid: fn.launches for kid, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    from repro_torch.launch.serve import summarize

    stats = summarize(done)
    print(f"[{tag}] cold run: {stats['requests']} requests over buckets "
          f"{buckets}, {stats['tokens']} tokens in {wall:.3f}s "
          f"({stats['tokens'] / wall:.1f} tok/s), TTFT p50 "
          f"{stats['ttft_p50_s'] * 1e3:.1f} ms p99 "
          f"{stats['ttft_p99_s'] * 1e3:.1f} ms, peak memory {peak_gb:.2f} GiB")
    print(f"[{tag}] admissions {admissions}, decode steps {decode_steps}, "
          "launches " + " ".join(f"{k} {v}" for k, v in launches.items()))
    for rid, s in done.items():
        if s.finish_reason not in VALID_REASONS or not s.generated or \
                not all(0 <= tok < cfg.vocab_size for tok in s.generated):
            raise AssertionError(f"{tag} request {rid}: {s.finish_reason} "
                                 f"{s.generated}")
    if admissions < len(prompts) or not decode_steps:
        raise AssertionError(f"{tag}: {admissions} admissions, "
                             f"{decode_steps} decode steps")
    want = expected(admissions, decode_steps)
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != expected {want} "
                             f"({admissions} admissions, {decode_steps} "
                             f"decode steps, {cfg.num_layers} layers)")
    with torch.inference_mode():
        logits, _, _ = engine.executor.prefill(prompts[0])
    if logits.shape != (1, 32, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"{tag}: prefill logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    for rid in (7, 1):                           # padded buckets 256, 32
        engine.submit(Request(100 + rid, prompts[rid], max_new_tokens=16))
        alone = engine.run()[100 + rid].generated
        if alone != done[rid].generated:
            raise AssertionError(f"{tag}: request {rid} alone {alone} != "
                                 f"batched {done[rid].generated}")
    print(f"[{tag}] requests 7 and 1 run alone give their batched tokens")
    return done, launches


def where_time_goes(torch, tag, engine, prompts, done, families=None,
                    prefill_label="prefill bucket 256"):
    """The workload again on the warm engine (TTFT, tokens/s), then one
    profiler window over 5 warm decode steps and one over request 7's
    prefill (bucket 256; its own 200 tokens where prompts are not
    bucketed, ``prefill_label`` naming it). ``families``: {kernel id:
    substrings of its device kernels' names}, whose device time in each
    window is printed (and returned as {window label: {kernel id: ms a
    step or a prefill}})."""
    from repro_torch.launch.serve import summarize

    done2, _, steps2, wall2 = run_workload(torch, engine, prompts, 1000)
    if any(done2[r].generated != done[r].generated for r in prompts):
        raise AssertionError(f"{tag}: the warm run changed a request's "
                             "tokens")
    stats2 = summarize(done2)
    print(f"[{tag} time] warm run: {stats2['tokens']} tokens in {wall2:.3f}s "
          f"({stats2['tokens'] / wall2:.1f} tok/s), TTFT p50 "
          f"{stats2['ttft_p50_s'] * 1e3:.1f} ms p99 "
          f"{stats2['ttft_p99_s'] * 1e3:.1f} ms (queue wait included), "
          f"{steps2} decode steps")
    ex = engine.executor
    shares = {}

    def count_of(by_name, subs):
        return sum(any(sub in name for sub in subs) for name in by_name)

    toks = torch.zeros((4, 1), dtype=torch.long)
    pos = torch.full((4,), 10, dtype=torch.int32)

    def decode5():
        for _ in range(5):
            ex.decode(toks, pos)

    def prefill256():
        with torch.inference_mode():
            ex.prefill(prompts[7])

    for label, fn, reps in (("decode step", decode5, 5),
                            (prefill_label, prefill256, 1)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t_enqueued = time.perf_counter()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        enqueue_ms = (t_enqueued - t0) * 1e3 / reps
        busy_ms, by_name, count, ops_ms = device_profile(torch, fn)
        busy_ms /= reps
        syncs = count_syncs(torch, fn)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        for kid, subs in (families or {}).items():
            fam_ms = sum(ms for name, ms in by_name.items()
                         if any(sub in name for sub in subs)) / reps
            shares.setdefault(label, {})[kid] = fam_ms
            print(f"[{tag} time] {label}: {kid} {fam_ms:.3f} ms of the "
                  f"{busy_ms:.2f} ms device busy ({count_of(by_name, subs)} "
                  f"kernel names)")
        print(f"[{tag} time] {label}: wall {wall_ms:.2f} ms, device busy "
              f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.0f}%, idle "
              f"{100 * (1 - busy_ms / wall_ms):.0f}%), {count / reps:.0f} "
              "device kernels; top kernels "
              + "; ".join(f"{name[:48]} {ms / reps:.3f} ms"
                          for name, ms in top))
        print(f"[{tag} time] {label} host: enqueue {enqueue_ms:.2f} ms of "
              f"the {wall_ms:.2f} ms wall, {ops_ms / reps:.2f} ms inside "
              f"profiled operators (profiler on), {syncs / reps:.0f} "
              "synchronizing calls (the inputs' host-to-device copies)")
    return shares


def tensor_core_opcodes(lib_path):
    """``{"HMMA": n, "GMMA": m}``: the tensor-core instructions in a
    library's SASS (``cuobjdump -sass``), or None where the toolkit has no
    ``cuobjdump``."""
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    exe = shutil.which("cuobjdump")
    if exe is None and CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "cuobjdump"
        exe = str(cand) if cand.exists() else None
    if exe is None:
        return None
    sass = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300).stdout
    return {op: sum(op in ln for ln in sass.splitlines())
            for op in ("HMMA", "GMMA")}


def report_build(torch, kid, name, tensor_cores=True):
    """Print kernel ``kid``'s library ``name``: each kernel instance's
    ``-Xptxas -v`` registers and spills (the instance's name demangled by
    ``c++filt`` where the toolkit's host has it), and the tensor-core
    instructions (``HMMA`` / ``GMMA``) in its SASS; fail where the SASS
    holds none of a kernel that runs its products there
    (``tensor_cores``)."""
    import re
    import shutil

    from repro_torch.kernels import _build

    paths = _build.build_all()
    log = _build.build_report().get(name, (0.0, ""))[1]
    report, entry = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
            if shutil.which("c++filt"):
                full = subprocess.run(["c++filt", entry], capture_output=True,
                                      text=True).stdout
                # the kernel and its template arguments, e.g.
                # tensor_sketch_kernel<float, 8>
                m = re.search(r"(\w+<[^()]*>)\(", full)
                entry = m.group(1) if m else entry
        elif "spill" in ln or "Used" in ln:
            report.append((f"{entry}: " if entry and "spill" in ln else "")
                          + ln.split("info    :")[-1].strip())
    print(f"[{kid}] ptxas -v: " + (" | ".join(report) if report else
                                   "no report: the library was built "
                                   "before this run"))
    ops = tensor_core_opcodes(paths[name])
    print(f"[{kid}] tensor-core instructions in the SASS of lib{name}: "
          f"{ops if ops is not None else 'no cuobjdump'}")
    if tensor_cores and ops is not None and ops["HMMA"] + ops["GMMA"] == 0:
        raise AssertionError(f"{kid}: no tensor-core instruction")


def b5_check(torch, label, zq, zk, v, chunk, eps, kernels, record):
    """Kernel B5 on features ``zq, zk [1, BH, T, F]`` and values ``v``:
    the two-launch causal op against the plain chunked version and the
    O(T^2) evaluation (``B5_TOL``), pass B alone against its plain version
    (``B5_TOL``) and, in fp32, within ``B5_FP32_TOL`` of the plain version
    evaluated in float64 (3xTF32's precision), two calls bitwise equal; its
    device time (profiler) and CUDA-event time, the plain version's, its
    grid, and the bounds on the tensor cores and on the CUDA cores. Fills
    ``kernels["B5"]`` where ``record``. Returns the checks as ``(label,
    err, tol)``."""
    from repro_torch.kernels.rm_attention.ops import (
        rm_attention_causal,
        rm_attention_chunked,
    )
    from repro_torch.kernels.rm_attention.ref import (
        causal_chunked_ref,
        chunk_states,
        rm_attention_chunked_ref,
        rm_attention_ref,
    )

    _, bh, t, f = zq.shape
    dh = v.shape[-1]
    got = rm_attention_causal(zq, zk, v, chunk=chunk, eps=eps)
    want = causal_chunked_ref(zq, zk, v, chunk, eps)
    quad = rm_attention_ref(zq, zk, v, eps=eps)
    s_prev, n_prev = chunk_states(zk, v, chunk)
    n_ch = t // chunk
    pb = (zq.reshape(bh, t, f), zk.reshape(bh, t, f), v.reshape(bh, t, dh),
          s_prev.reshape(bh, n_ch, f, dh), n_prev.reshape(bh, n_ch, f))
    got_b = rm_attention_chunked(*pb, chunk=chunk, eps=eps)
    again = rm_attention_chunked(*pb, chunk=chunk, eps=eps)
    sched = rm_attention_chunked.last_schedule
    want_b = rm_attention_chunked_ref(*pb, chunk=chunk, eps=eps)
    want64 = rm_attention_chunked_ref(*(a.double() for a in pb), chunk=chunk,
                                      eps=eps)
    torch.cuda.synchronize()
    checks, errs = [], []
    for name, g_, w_, tol_ in (("causal", got, want, B5_TOL),
                               ("pass B", got_b, want_b, B5_TOL),
                               ("vs quadratic", got, quad, B5_TOL),
                               ("pass B vs float64", got_b.double(), want64,
                                B5_FP32_TOL)):
        err = (g_ - w_).abs().max().item()
        tol = tol_ * max(1.0, w_.abs().max().item())
        errs.append((err, tol))
        checks.append((f"{label} {name}", err, tol))
        if not err <= tol:
            raise AssertionError(f"B5 {label} {name}: error {err} > {tol}"
                                 + (": not 3xTF32-accurate"
                                    if tol_ == B5_FP32_TOL else ""))
    bitwise = torch.equal(got_b, again)
    if not bitwise:
        raise AssertionError(f"B5 {label}: two calls differ")
    ms = time_ms(torch, lambda: rm_attention_chunked(
        *pb, chunk=chunk, eps=eps), iters=20)
    dev_ms = kernel_device_ms(torch, lambda: rm_attention_chunked(
        *pb, chunk=chunk, eps=eps), "rm_attention_chunked_kernel", iters=20)
    plain_ms = time_ms(torch, lambda: rm_attention_chunked_ref(
        *pb, chunk=chunk, eps=eps), iters=20)
    nbytes, ops = chunked_cost(bh, t, f, dh, chunk, 4)
    bms, by = bound(nbytes, ops, "float32")
    tcms, tcby = tensor_core_bound(nbytes, 0, ops, "float32", False)
    print(f"[B5] {label} zq,zk[{bh},{t},{f}] v dv {dh} chunk {chunk} fp32: "
          "max_abs_err causal/pass B/vs quadratic/pass B vs float64 "
          + "/".join(f"{e_:.3e}" for e_, _ in errs) + " (tol "
          + "/".join(f"{t_:.1e}" for _, t_ in errs) + f"; 3xTF32 gate "
          f"{B5_FP32_TOL:.0e}), two calls bitwise equal {bitwise}; kernel "
          f"{dev_ms:.4f} ms device (profiler), {ms:.4f} ms events; plain "
          f"{plain_ms:.4f} ms; bound {tcms:.5f} ms ({tcby}, tensor cores) / "
          f"{bms:.5f} ms ({by}, CUDA cores); grid {sched.blocks} blocks "
          f"({sched.blocks // 2} clusters of two: {sched.rows}-row query "
          f"tiles, {sched.q_tiles} a chunk; {sched.n_groups} value "
          "group(s))")
    if record:
        hus = host_us(torch, lambda: rm_attention_chunked(
            *pb, chunk=chunk, eps=eps), iters=50)
        print(f"[B5] host time {hus:.1f} us a call")
        kernels["B5"] = dict(
            name="rm_attention_chunked", route="cuda",
            source="src/repro_torch/csrc/rm_attention_chunked.cu",
            replaces="src/repro/kernels/rm_attention/rm_attention.py:78",
            shape=f"zq,zk[{bh},{t},{f}] fp32, dv {dh}, chunk {chunk}",
            ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=tcms,
            bound_by=tcby, library_ms=None, bound_cuda_core_ms=bms,
            grid=sched.blocks, host_us=hus)
    elif "B5" in kernels:
        kernels["B5"].update({f"{label.replace(' ', '_')}_ms": ms,
                              f"{label.replace(' ', '_')}_device_ms": dev_ms,
                              f"{label.replace(' ', '_')}_bound_ms": tcms})
    return checks


def structured_plan_check(torch, label, x, plan, params, packed, full,
                          full_bound_ms, checks):
    """B8 through ``apply_structured_plan`` on fp32 rows ``x``: the map must
    equal the full-width output ``full`` (B8 on the same rows) sliced by
    bucket after the prefix columns, bitwise; B8's device time in the call
    and every device kernel's (profiler), beside the bounds of the full-width
    launch, of the kept-columns launch, and of the whole map (x read once,
    every column written once). Returns the numbers for the kernels line."""
    from repro_torch.core.plan import prefix_columns
    from repro_torch.structured.plan import apply_structured_plan

    rows = x.shape[0]
    got = apply_structured_plan(plan, params, x, packed=packed)
    pieces, off = [], 0
    for c, n_st in zip(plan.counts, plan.stacks_per_bucket):
        pieces.append(full[:, off: off + c])
        off += n_st * plan.d_pad
    want = torch.cat(prefix_columns(plan, x, torch.float32) + pieces, dim=-1)
    same = torch.equal(got, want)
    again = torch.equal(got, apply_structured_plan(plan, params, x,
                                                   packed=packed))
    if not (same and again):
        raise AssertionError(f"B8 {label} through apply_structured_plan: "
                             f"equal to full width sliced {same}, two calls "
                             f"equal {again}")
    def call():
        apply_structured_plan(plan, params, x, packed=packed)

    dev_ms = kernel_device_ms(torch, call, ("structured_feature_kernel",
                                            "structured_split"))
    all_ms = kernel_device_ms(torch, call, "")
    host = host_us(torch, call)
    kept_bytes, kept_ops = structured_cost(rows, plan, 4, kept=True)
    kept_ms, _ = bound(kept_bytes, kept_ops, "float32")
    map_ms = (rows * plan.input_dim * 4 + rows * plan.output_dim * 4) \
        / HBM_BYTES_PER_S * 1e3
    print(f"[B8] {label} x[{rows},{plan.input_dim}] through "
          f"apply_structured_plan (F {plan.output_dim}, {plan.num_random_cols}"
          f" kept of {plan.padded_num_cols} computed): equal to full width "
          f"sliced, bitwise; B8 {dev_ms:.4f} ms device, every kernel of the "
          f"call {all_ms:.4f} ms, host {host:.1f} us; bounds: full width "
          f"{full_bound_ms:.6f} ms, kept columns {kept_ms:.6f} ms, the whole "
          f"map {map_ms:.6f} ms (bytes)")
    key = "decode" if label == "decode" else "prefill"
    return {f"{key}_apply_ms": dev_ms, f"{key}_apply_all_ms": all_ms,
            f"{key}_kept_bound_ms": kept_ms, f"{key}_map_bound_ms": map_ms}


def structured_split_phase(torch, gen, fn, ref, checks):
    """B8's split path (d_pad past 8192): an exp plan at D 4000 on 64 rows
    of d 9000 (d_pad 16384) and of d 40000 (d_pad 65536), fp32 and bf16,
    against its plain version, two calls bitwise equal, surplus columns 0;
    in fp32 through ``apply_structured_plan`` (the kept columns bitwise the
    full width sliced), and at d 40000 once more with a scratch budget of 8
    rows (the rows in 8 chunks), bitwise the one-budget result. Returns the
    numbers for the kernels line."""
    from repro_torch.core import ExponentialDotProductKernel
    from repro_torch.core.plan import plan_columns
    from repro_torch.kernels import common as kcommon
    from repro_torch.structured.plan import (
        init_structured_params,
        make_structured_plan,
        pack_structured,
    )

    rows, out = 64, {}
    for d in (9000, 40000):
        plan = make_structured_plan(ExponentialDotProductKernel(1.0), d,
                                    4000, measure="proportional", n_max=8)
        params = init_structured_params(plan, gen)
        packed = pack_structured(plan, params)
        cd, cs = plan_columns(plan, "cuda")
        m = plan.d_pad
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x = unit_rows(torch, (rows, d), gen).to(dtype)
            args = (x, *(p_.to(dtype) for p_ in packed), cd, cs)
            got = fn(*args)
            sched = fn.last_schedule
            repeat_ok = torch.equal(got, fn(*args))
            want = ref(*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = B8_TOL * max(1.0, want.abs().max().item())
            surplus_ok = not got[:, cs == 0].any()
            chunks_ok = True
            if d == 40000 and dtype == torch.float32:
                saved = kcommon.STRUCTURED_SCRATCH_BYTES
                kcommon.STRUCTURED_SCRATCH_BYTES = \
                    8 * plan.max_degree * plan.total_stacks * m * 4
                try:
                    chunks_ok = torch.equal(fn(*args), got)
                finally:
                    kcommon.STRUCTURED_SCRATCH_BYTES = saved
            ms = kernel_device_ms(torch, lambda: fn(*args),
                                  "structured_split", iters=10)
            event_ms = time_ms(torch, lambda: fn(*args), iters=10)
            plain_ms = time_ms(torch, lambda: ref(*args), iters=3, warmup=1)
            nbytes, ops = structured_cost(rows, plan, x.element_size())
            bms, by = bound(nbytes, ops, dname)
            print(f"[B8] split path d {d} (d_pad {m}, passes {sched.passes},"
                  f" {plan.total_stacks} stacks, {plan.max_degree} slots) "
                  f"x[{rows},{d}] {dname}: max_abs_err {err:.3e} (tol "
                  f"{tol:.1e}), two calls bitwise equal {repeat_ok}, in 8 "
                  f"chunks bitwise equal {chunks_ok}; kernels {ms:.4f} ms "
                  f"device (every pass), {event_ms:.4f} ms events, plain "
                  f"{plain_ms:.4f} ms, bound {bms:.5f} ms ({by})")
            if not (err <= tol and repeat_ok and surplus_ok and chunks_ok
                    and sched.passes):
                raise AssertionError(f"B8 split path d {d} {dname}: error "
                                     f"{err} > {tol}, two calls or chunks "
                                     "differ, or surplus not 0")
            checks.append((f"d_pad {m} {dname}", err, tol))
            if dtype == torch.float32:
                applied = structured_plan_check(
                    torch, f"d_pad {m}", x, plan, params, packed, got, bms,
                    checks)
                out.update({f"dpad{m}_ms": ms, f"dpad{m}_events_ms": event_ms,
                            f"dpad{m}_plain_ms": plain_ms,
                            f"dpad{m}_bound_ms": bms,
                            f"dpad{m}_apply_ms": applied["prefill_apply_ms"]})
            del x, args, got, want
    return out


def noncausal_phase(torch, np, gen, kernels):
    """Phase 11: kernels B3 and B4 against their plain versions at every
    shape the encoder gives them, their schedules, registers and
    tensor-core instructions, B3's repeatability, their times beside both
    bounds, and the whole op against the O(T^2) evaluation. Fills
    ``kernels["B3"]`` and ``kernels["B4"]`` (``bound_ms`` on the tensor
    cores, where both kernels run their products; ``bound_cuda_core_ms``
    the same work on the fp32 CUDA cores); returns ``(hcfg, hd, hf)``."""
    from repro_torch.configs import get_config
    from repro_torch.core.plan import init_omegas, pack_omegas, plan_columns
    from repro_torch.kernels.common import round_up
    from repro_torch.kernels.rm_attention.noncausal import pack_noncausal
    from repro_torch.kernels.rm_attention.ops import (
        rm_attention_fused_noncausal,
        rm_fused_apply,
        rm_fused_state,
    )
    from repro_torch.kernels.rm_attention.ref import (
        featurize_ref4,
        rm_attention_ref,
        rm_fused_apply_ref,
        rm_fused_state_ref,
    )
    from repro_torch.models.attention import rm_plan_for

    hcfg = get_config("hubert-xlarge", attention_mode="rm")
    hd = hcfg.resolved_head_dim
    hplan = rm_plan_for(hcfg, hd)
    hw32 = pack_omegas(hplan, init_omegas(hplan, gen))
    h_deg, h_scale = plan_columns(hplan, "cuda")
    h_deg_np = hplan.column_degrees()
    hf = hw32.shape[1]
    eps = hcfg.rm.eps
    print(f"[plan] hubert-xlarge rm head: packed w {tuple(hw32.shape)}, "
          f"F={hf} columns, degrees {np.bincount(h_deg_np).tolist()}")
    # the slab both kernels read, once per dtype (as the model packs it once
    # per weight set)
    packs = {dtype: pack_noncausal(hw32.to(dtype), h_deg_np,
                                   hplan.column_scales())
             for dtype in (torch.float32, torch.bfloat16)}
    print(f"[plan] B3/B4 slab: {packs[torch.float32].slab.shape[0]} rows "
          f"of d {hd} for {int(h_deg_np.sum())} used slots, "
          f"{packs[torch.float32].num_col_tiles} column tiles of 8")
    for kid, name in (("B3", "rm_fused_state"), ("B4", "rm_fused_apply")):
        report_build(torch, kid, name)
    # the shapes the encoder gives B3 and B4 (the rows go in unpadded):
    # the 8 x 1500 encode (the kernels line's times), its rows padded to
    # the reference's chunk with kvalid 0 on the padded keys, and the
    # 1 x 32768 encode (the longest fp32 sums; its times go in the kernels
    # line too)
    b3_checks, b4_checks = [], []
    nh = hcfg.num_heads
    for case, bh, t, valid_t, iters in (
            ("encode", ENC_CLIPS * nh, ENC_FRAMES, ENC_FRAMES, 20),
            ("padded", ENC_CLIPS * nh, round_up(ENC_FRAMES, hcfg.rm.chunk),
             ENC_FRAMES, 20),
            ("long", nh, LONG_FRAMES, LONG_FRAMES, 10)):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            item = torch.tensor([], dtype=dtype).element_size()
            k = unit_rows(torch, (bh, t, hd), gen).to(dtype)
            q = unit_rows(torch, (bh, t, hd), gen).to(dtype)
            v = torch.randn((bh, t, hd), generator=gen, device="cuda")
            kvalid = torch.ones((bh, t), device="cuda")
            kvalid[:, valid_t:] = 0.0
            w = hw32.to(dtype)
            pack = packs[dtype]
            state_args = (k, v, kvalid, w, h_deg, h_scale)
            s_got, n_got = rm_fused_state(*state_args, pack=pack)
            sched3 = rm_fused_state.last_schedule
            s_again, n_again = rm_fused_state(*state_args, pack=pack)
            torch.cuda.synchronize()
            if not (torch.equal(s_got, s_again)
                    and torch.equal(n_got, n_again)):
                raise AssertionError(f"B3 {case} {dname}: two calls differ")
            del s_again, n_again
            s_ref, n_ref = rm_fused_state_ref(*state_args)
            # B4 on the plain state, so its check does not inherit B3's
            # error
            apply_args = (q, s_ref, n_ref, w, h_deg, h_scale, eps)
            out_got = rm_fused_apply(*apply_args, pack=pack)
            sched4 = rm_fused_apply.last_schedule
            out_ref = rm_fused_apply_ref(*apply_args)
            torch.cuda.synchronize()
            errs = {}
            for name, got, want, tol_, checks in (
                    ("S", s_got, s_ref, B3_TOL, b3_checks),
                    ("n", n_got, n_ref, B3_TOL, b3_checks),
                    ("out", out_got, out_ref, B4_TOL, b4_checks)):
                err = (got - want).abs().max().item()
                scale = max(1.0, want.abs().max().item())
                tol = tol_ * scale
                errs[name] = (err, tol, err / scale)
                checks.append((f"{name} {case} {dname}", err, tol))
                if not (err <= tol and torch.isfinite(got).all()):
                    raise AssertionError(f"B3/B4 {name} {case} {dname}: "
                                         f"error {err} > {tol}")
                # fp32 inputs: the 3xTF32 precision
                if dtype == torch.float32 and not err <= B34_FP32_TOL * scale:
                    raise AssertionError(
                        f"B3/B4 {name} {case} fp32: error {err / scale:.2e}"
                        f" x max(1, max |plain|) > {B34_FP32_TOL}: not "
                        f"3xTF32-accurate")
            print(f"[B3/B4] {case} {dname}: max_abs_err / max(1, max "
                  f"|plain|) S {errs['S'][2]:.2e}, n {errs['n'][2]:.2e}, "
                  f"out {errs['out'][2]:.2e}"
                  + (f" (3xTF32 gate {B34_FP32_TOL:.0e})"
                     if dtype == torch.float32 else ""))
            del s_ref, n_ref, out_ref, s_got, n_got, out_got
            ms3 = time_ms(torch, lambda: rm_fused_state(*state_args,
                                                        pack=pack),
                          iters=iters)
            plain3 = time_ms(torch, lambda: rm_fused_state_ref(*state_args),
                             iters=5)
            ms4 = time_ms(torch, lambda: rm_fused_apply(*apply_args,
                                                        pack=pack),
                          iters=iters)
            plain4 = time_ms(torch, lambda: rm_fused_apply_ref(*apply_args),
                             iters=5)
            valid = int(kvalid.sum().item())
            cost3 = state_cost(bh, t, valid, hd, hd, h_deg_np, item)
            cost4 = apply_cost(bh, t, hd, hd, h_deg_np, item)
            (b3ms, b3by), (b4ms, b4by) = (
                bound(c[0], c[1] + c[2], dname) for c in (cost3, cost4))
            (tc3, tc3by), (tc4, tc4by) = (
                tensor_core_bound(*c, dname, pack.tf32_exact)
                for c in (cost3, cost4))
            print(f"[B3] {case} k,v[{bh},{t},{hd}] ({t - valid_t} keys a "
                  f"row padded) {dname}: max_abs_err S/n {errs['S'][0]:.3e}/"
                  f"{errs['n'][0]:.3e} (tol {errs['S'][1]:.1e}/"
                  f"{errs['n'][1]:.1e}), two calls bitwise equal; kernel "
                  f"{ms3:.4f} ms, plain {plain3:.4f} ms, bound {tc3:.5f} ms "
                  f"({tc3by}, tensor cores) / {b3ms:.5f} ms ({b3by}, CUDA "
                  f"cores); grid "
                  f"{sched3.blocks} blocks = {bh} rows x {sched3.splits} "
                  f"splits of {sched3.tiles_per_split} key tiles x "
                  f"{sched3.n_fgroups * sched3.n_dvgroups} groups, "
                  f"{sched3.smem_bytes} B shared")
            print(f"[B4] {case} q[{bh},{t},{hd}] {dname}: max_abs_err out "
                  f"{errs['out'][0]:.3e} (tol {errs['out'][1]:.1e}) kernel "
                  f"{ms4:.4f} ms, plain {plain4:.4f} ms, bound {tc4:.5f} ms "
                  f"({tc4by}, tensor cores) / {b4ms:.5f} ms ({b4by}, CUDA "
                  f"cores); grid "
                  f"{sched4.blocks} blocks = {bh} rows x {sched4.splits} "
                  f"splits of {sched4.tiles_per_split} query tiles x "
                  f"{sched4.n_dvgroups} groups, {sched4.smem_bytes} B shared")
            if dtype == torch.float32 and case == "encode":
                us3 = host_us(torch, lambda: rm_fused_state(*state_args,
                                                            pack=pack),
                              iters=50)
                us4 = host_us(torch, lambda: rm_fused_apply(*apply_args,
                                                            pack=pack),
                              iters=50)
                print(f"[B3] host time {us3:.1f} us a call; [B4] host time "
                      f"{us4:.1f} us a call")
                shape = f"BH {bh}, T {t}, d = dv = {hd}, " \
                        f"w{tuple(hw32.shape)} fp32"
                kernels["B3"] = dict(
                    name="rm_fused_state", route="cuda",
                    source="src/repro_torch/csrc/rm_fused_state.cu",
                    replaces="src/repro/kernels/rm_attention/fused.py:273",
                    shape=shape, ms=ms3, plain_ms=plain3, bound_ms=tc3,
                    bound_by=tc3by, library_ms=None,
                    bound_cuda_core_ms=b3ms, grid=sched3.blocks,
                    splits=sched3.splits)
                kernels["B4"] = dict(
                    name="rm_fused_apply", route="cuda",
                    source="src/repro_torch/csrc/rm_fused_apply.cu",
                    replaces="src/repro/kernels/rm_attention/fused.py:353",
                    shape=shape, ms=ms4, plain_ms=plain4, bound_ms=tc4,
                    bound_by=tc4by, library_ms=None,
                    bound_cuda_core_ms=b4ms, grid=sched4.blocks,
                    splits=sched4.splits)
            elif dtype == torch.float32 and case == "long":
                for kid, ms_, plain_, bms_, tc_, sch in (
                        ("B3", ms3, plain3, b3ms, tc3, sched3),
                        ("B4", ms4, plain4, b4ms, tc4, sched4)):
                    kernels[kid].update(
                        long_shape=f"BH {bh}, T {t} fp32", long_ms=ms_,
                        long_plain_ms=plain_, long_bound_ms=tc_,
                        long_bound_cuda_core_ms=bms_, long_grid=sch.blocks,
                        long_splits=sch.splits)
            del k, q, v, kvalid, state_args, apply_args
            torch.cuda.empty_cache()
    # past the depth the kernels take whole (d 384 fp32 / 768 bf16 for B3,
    # 536 / 1072 for B4 on this depth-5 plan) d is tiled: the hubert plan
    # at head width 640 (fp32) and 1088 (bf16), 16 rows of 1500 frames
    for d_deep, dtype in ((640, torch.float32), (1088, torch.bfloat16)):
        dname = str(dtype).split(".")[-1]
        dplan = rm_plan_for(hcfg, d_deep)
        wd = pack_omegas(dplan, init_omegas(dplan, gen)).to(dtype)
        dd_deg, dd_scale = plan_columns(dplan, "cuda")
        bh, t = nh, ENC_FRAMES
        k = unit_rows(torch, (bh, t, d_deep), gen).to(dtype)
        q = unit_rows(torch, (bh, t, d_deep), gen).to(dtype)
        v = torch.randn((bh, t, hd), generator=gen, device="cuda")
        kvalid = torch.ones((bh, t), device="cuda")
        kvalid[bh // 2:, t - 36:] = 0.0
        state_args = (k, v, kvalid, wd, dd_deg, dd_scale)
        s_got, n_got = rm_fused_state(*state_args)
        sched3 = rm_fused_state.last_schedule
        s_ref, n_ref = rm_fused_state_ref(*state_args)
        apply_args = (q, s_ref, n_ref, wd, dd_deg, dd_scale, eps)
        out_got = rm_fused_apply(*apply_args)
        sched4 = rm_fused_apply.last_schedule
        out_ref = rm_fused_apply_ref(*apply_args)
        torch.cuda.synchronize()
        errs = []
        for name, got, want, tol_, checks in (
                ("S", s_got, s_ref, B3_TOL, b3_checks),
                ("n", n_got, n_ref, B3_TOL, b3_checks),
                ("out", out_got, out_ref, B4_TOL, b4_checks)):
            err = (got - want).abs().max().item()
            scale = max(1.0, want.abs().max().item())
            if dtype == torch.float32:
                tol_ = B34_FP32_TOL
            errs.append(err / scale)
            checks.append((f"{name} d{d_deep} {dname}", err, tol_ * scale))
            if not (err <= tol_ * scale and torch.isfinite(got).all()):
                raise AssertionError(f"B3/B4 {name} d {d_deep} {dname}: "
                                     f"error {err / scale:.2e} x max(1, max "
                                     f"|plain|) > {tol_}")
        ms3 = time_ms(torch, lambda: rm_fused_state(*state_args), iters=5)
        ms4 = time_ms(torch, lambda: rm_fused_apply(*apply_args), iters=5)
        print(f"[B3/B4] d {d_deep} (tiled in chunks of {sched3.dk} / "
              f"{sched4.dk} of dp {sched3.dp}) k,q[{bh},{t},{d_deep}] "
              f"{dname}: max_abs_err / max(1, max |plain|) S {errs[0]:.2e}, "
              f"n {errs[1]:.2e}, out {errs[2]:.2e}"
              + (f" (3xTF32 gate {B34_FP32_TOL:.0e})"
                 if dtype == torch.float32 else "")
              + f"; B3 {ms3:.4f} ms ({sched3.blocks} blocks, "
              f"{sched3.smem_bytes} B shared), B4 {ms4:.4f} ms "
              f"({sched4.blocks} blocks, {sched4.smem_bytes} B shared)")
        if not (sched3.dk < sched3.dp and sched4.dk < sched4.dp):
            raise AssertionError(f"d {d_deep}: the schedules did not tile d")
        del k, q, v, state_args, apply_args, s_ref, n_ref, out_ref
        torch.cuda.empty_cache()
    # the whole op (B3, B4 on the unpadded rows) against the O(T^2) direct
    # evaluation
    q4 = unit_rows(torch, (2, 8, ENC_FRAMES, hd), gen)
    k4 = unit_rows(torch, (2, 8, ENC_FRAMES, hd), gen)
    v4 = torch.randn((2, 8, ENC_FRAMES, hd), generator=gen, device="cuda")
    kv4 = torch.ones((2, ENC_FRAMES), device="cuda")
    kv4[1, ENC_FRAMES - 100:] = 0.0
    got = rm_attention_fused_noncausal(q4, k4, v4, hw32, h_deg, h_scale,
                                       kvalid=kv4, eps=eps)
    zq4 = featurize_ref4(q4, hw32, h_deg, h_scale)
    zk4 = featurize_ref4(k4, hw32, h_deg, h_scale) * kv4[:, None, :, None]
    want = rm_attention_ref(zq4, zk4, v4, causal=False, eps=eps)
    err = (got - want).abs().max().item()
    tol = B4_TOL * max(1.0, want.abs().max().item())
    print(f"[B3+B4] fused non-causal op [16, {ENC_FRAMES}, {hd}] fp32 vs the "
          f"O(T^2) "
          f"direct evaluation: max_abs_err {err:.3e} (tol {tol:.1e})")
    if not err <= tol:
        raise AssertionError(f"fused non-causal vs O(T^2): {err} > {tol}")
    b4_checks.append(("op vs O(T^2)", err, tol))
    for kid, checks in (("B3", b3_checks), ("B4", b4_checks)):
        label, err, tol = worst(checks)
        kernels[kid].update(max_abs_err=err, tol=tol, check=label)
    return hcfg, hd, hf


# -- phase 24: training on the card ------------------------------------------
TRAIN_GRAD_TOL = 1e-4   # x max(1, max |g_cpu|): one fp32 formulation
#                         differentiated on both devices, sums reordered
TRAIN_METRIC_TOL = 1e-4  # relative: loss and grad_norm card vs CPU
TRAIN_STEPS = 8          # qwen3-1.7b steps through the Trainer
TRAIN_DEPTH = 8          # of qwen3-1.7b's 28 layers in 24 c: the save and
#                          restore of the whole model's 20 GB train state
#                          took 76 s of the script's 1200
TRAIN_BATCH, TRAIN_SEQ = 4, 256
ENC_TRAIN_CLIPS = 2      # hubert-xlarge clips of ENC_FRAMES in its step


def train_launches(cfg) -> int:
    """A fused attention kernel's launches a train step (every layer of
    ``cfg`` attends): one a layer in forward, and one again a layer of each
    checkpointed group in its recompute under ``cfg.remat`` (the
    ``first_k_dense`` layers are not checkpointed)."""
    again = cfg.num_layers - cfg.first_k_dense if cfg.remat else 0
    return cfg.num_layers + again


def trainable_grads(cfg, params, batch):
    """``({path: grad}, loss)`` of ``loss_fn`` for every trainable float
    leaf (``train.steps.loss_grads``, flattened)."""
    from repro_torch.common.tree import flatten_dict
    from repro_torch.optim.adamw import is_frozen
    from repro_torch.train.steps import loss_grads

    grads, metrics = loss_grads(cfg, params, batch)
    return ({k: g for k, g in flatten_dict(grads).items()
             if not is_frozen(tuple(k.split("/")))
             and g.is_floating_point()}, metrics["loss"])


def tree_to(p, device):
    if isinstance(p, dict):
        return {k: tree_to(v, device) for k, v in p.items()}
    if isinstance(p, list):
        return [tree_to(v, device) for v in p]
    return p.to(device)


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def function_grad_check(torch, label, fn, forward_only, args, counters,
                        kernel_ids):
    """One differentiable op on the card against the same op on the CPU:
    the forward bitwise ``forward_only`` (the kernels' wrappers without
    autograd) with one launch of each of ``kernel_ids`` and none of the
    other RM kernels, no RM launch in the backward, and the cotangents of
    the first three args (q, k, v) within TRAIN_GRAD_TOL of the CPU's.
    ``args``: CUDA tensors, the first three differentiated."""
    with torch.no_grad():
        plain = forward_only(*args)
    cot = torch.randn(plain.shape, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(9))
    xs = [a.detach().requires_grad_() for a in args[:3]]
    before = {k: fn_.launches for k, fn_ in counters.items()}
    t0 = time.perf_counter()
    out = fn(*xs, *args[3:])
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    mid = {k: fn_.launches for k, fn_ in counters.items()}
    t0 = time.perf_counter()
    grads = torch.autograd.grad(out, xs, cot)
    torch.cuda.synchronize()
    bwd_ms = (time.perf_counter() - t0) * 1e3
    after = {k: fn_.launches for k, fn_ in counters.items()}
    moved = {k: mid[k] - before[k] for k in counters}
    in_bwd = {k: after[k] - mid[k] for k in counters}
    want_moved = {k: int(k in kernel_ids) for k in counters}
    bitwise = torch.equal(out.detach(), plain)
    xc = [a.detach().cpu().requires_grad_() for a in args[:3]]
    rest = [a.cpu() if torch.is_tensor(a) else a for a in args[3:]]
    want = torch.autograd.grad(fn(*xc, *rest), xc, cot.cpu())
    errs = []
    for name, g, w in zip("qkv", grads, want):
        err = (g.float().cpu() - w.float()).abs().max().item()
        tol = TRAIN_GRAD_TOL * max(1.0, w.abs().max().item())
        errs.append((name, err, tol))
    print(f"[train a] {label}: forward bitwise the forward-only wrappers' "
          f"{bitwise}, launches forward {moved} (want {kernel_ids} once), "
          f"backward {sum(in_bwd.values())} RM launches; grads card vs CPU "
          + ", ".join(f"{n} {e:.2e} (tol {t:.1e})" for n, e, t in errs)
          + f"; forward {fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms (host "
          "clock, synchronized, cold)")
    if not (bitwise and moved == want_moved and not any(in_bwd.values())
            and all(e <= t for _, e, t in errs)):
        raise AssertionError(f"train a {label}: Function check failed")
    return max(e / t for _, e, t in errs)


def train_phase(torch, np, kernels, counters, w32, col_deg, col_scale,
                ts_feats):
    """Phase 24 (see the module doc): the three differentiable attention
    ops card vs CPU, the SMOKE models' gradients and one train step card vs
    CPU, qwen3-1.7b trained for TRAIN_STEPS steps through the Trainer with
    a checkpoint restored bitwise and one profiled warm step, and one
    hubert-xlarge train step."""
    import statistics
    import tempfile

    from repro_torch.common.tree import flatten_dict, tree_bytes
    from repro_torch.configs import get_config
    from repro_torch.core.plan import init_omegas, pack_omegas, plan_columns
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.kernels.rm_attention.ops import (
        _fused_causal_formulation,
        rm_attention_causal,
        rm_attention_chunked,
        rm_attention_fused_causal,
        rm_attention_fused_noncausal,
        rm_fused_apply,
        rm_fused_causal,
        rm_fused_state,
    )
    from repro_torch.kernels.rm_attention.ref import causal_chunked
    from repro_torch.models.attention import rm_plan_for
    from repro_torch.train.steps import (
        TrainHyper,
        init_train_state,
        make_train_step,
    )
    from repro_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(24)

    # a. each differentiable op's gradients, card against CPU, fp32
    b, h, t = 2, 8, 256                       # BH 16, the prefill shape
    d = w32.shape[2]
    q, k = unit_rows(torch, (b, h, t, d), gen), unit_rows(torch, (b, h, t, d),
                                                          gen)
    v = torch.randn((b, h, t, d), generator=gen, device="cuda")
    kvalid = torch.ones((b, t), device="cuda")
    kvalid[1, 200:] = 0.0
    function_grad_check(
        torch, "B2 (fused causal) BH 16 T 256 F "
        f"{w32.shape[1]}, padded keys",
        lambda q, k, v, kv, w, cd, cs: rm_attention_fused_causal(
            q, k, v, w, cd, cs, kvalid=kv),
        lambda q, k, v, kv, w, cd, cs: rm_fused_causal(
            q, k, v, kv, w, cd, cs, 1e-4)[0],
        (q, k, v, kvalid, w32, col_deg, col_scale), counters, ("B2",))
    hcfg = get_config("hubert-xlarge", attention_mode="rm")
    hd = hcfg.resolved_head_dim
    hplan = rm_plan_for(hcfg, hd)
    hw = pack_omegas(hplan, init_omegas(hplan, gen))
    h_deg, h_scale = plan_columns(hplan, "cuda")
    te = ENC_FRAMES
    q, k = (unit_rows(torch, (b, h, te, hd), gen) for _ in range(2))
    v = torch.randn((b, h, te, hd), generator=gen, device="cuda")
    kvalid = torch.ones((b, te), device="cuda")
    kvalid[1, te - 36:] = 0.0

    def noncausal_forward_only(q, k, v, kv, w, cd, cs):
        bh = q.shape[0] * q.shape[1]
        kval = kv[:, None, :].expand(q.shape[0], q.shape[1], te)
        s, n = rm_fused_state(k.reshape(bh, te, hd), v.reshape(bh, te, hd),
                              kval.reshape(bh, te), w, cd, cs)
        return rm_fused_apply(q.reshape(bh, te, hd), s, n, w, cd, cs,
                              1e-4).reshape(v.shape)

    function_grad_check(
        torch, f"B3 + B4 (fused non-causal) BH 16 T {te} d = dv = {hd}, "
        "padded keys",
        lambda q, k, v, kv, w, cd, cs: rm_attention_fused_noncausal(
            q, k, v, w, cd, cs, kvalid=kv),
        noncausal_forward_only, (q, k, v, kvalid, hw, h_deg, h_scale),
        counters, ("B3", "B4"))
    zq, zk, zv = ts_feats
    function_grad_check(
        torch, f"B5 (two-launch causal) BH 16 T 256 F {zq.shape[-1]} dv "
        f"{zv.shape[-1]}, keys padded from 200",
        lambda a, b_, c: rm_attention_causal(a, b_, c),
        lambda a, b_, c: causal_chunked(a, b_, c, 128, 1e-4,
                                        rm_attention_chunked),
        (zq, zk, zv), counters, ("B5",))
    del q, k, v, zq, zk, zv, hw

    # b. the SMOKE models in fp32, card against CPU
    hyper_small = TrainHyper(peak_lr=1e-3, warmup_steps=1, total_steps=8)
    rng = np.random.default_rng(24)
    for arch in ("qwen3-1.7b", "hubert-xlarge"):
        small = dataclasses.replace(
            get_config(arch, smoke=True, attention_mode="rm"),
            compute_dtype="float32")
        if small.frontend == "audio_stub":
            batch = {"embeds": torch.from_numpy(rng.standard_normal(
                (2, 40, small.d_model)).astype(np.float32)),
                "targets": torch.from_numpy(rng.integers(
                    0, small.vocab_size, size=(2, 40)))}
        else:
            toks = torch.from_numpy(rng.integers(0, small.vocab_size,
                                                 size=(2, 41)))
            batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        state_cpu = init_train_state(small, seed=3, hyper=hyper_small,
                                     device="cpu")
        state_gpu = tree_to(state_cpu, "cuda")
        batch_gpu = tree_to(batch, "cuda")
        g_cpu, loss_cpu = trainable_grads(small, state_cpu["params"], batch)
        g_gpu, loss_gpu = trainable_grads(small, state_gpu["params"],
                                          batch_gpu)
        ratio, worst_key = 0.0, None
        for key, g in g_cpu.items():
            err = (g_gpu[key].cpu() - g).abs().max().item()
            r = err / (TRAIN_GRAD_TOL * max(1.0, g.abs().max().item()))
            if r >= ratio:
                ratio, worst_key = r, key
        _, m_cpu = make_train_step(small, hyper_small)(state_cpu, batch)
        _, m_gpu = make_train_step(small, hyper_small)(state_gpu, batch_gpu)
        gaps = {key: abs(float(m_gpu[key]) - float(m_cpu[key]))
                / abs(float(m_cpu[key])) for key in ("loss", "grad_norm")}
        print(f"[train b] {small.name} fp32 rm: loss_fn {float(loss_gpu):.6f} "
              f"card, {float(loss_cpu):.6f} CPU; {len(g_cpu)} trainable "
              f"leaves, worst gradient {worst_key} at {ratio:.3f} of its "
              f"tolerance ({TRAIN_GRAD_TOL:.0e} x max(1, max |g|)); one "
              "train step card vs CPU: loss "
              f"{gaps['loss']:.2e}, grad_norm {gaps['grad_norm']:.2e} "
              f"relative (tol {TRAIN_METRIC_TOL:.0e})")
        if not (ratio <= 1.0 and all(x <= TRAIN_METRIC_TOL
                                     for x in gaps.values())):
            raise AssertionError(f"train b {small.name}: card vs CPU failed")
    del state_cpu, state_gpu, g_cpu, g_gpu

    # c. qwen3-1.7b at full width, TRAIN_DEPTH layers, through the Trainer
    cfg = dataclasses.replace(get_config("qwen3-1.7b", attention_mode="rm"),
                              num_layers=TRAIN_DEPTH).validate()
    layers = cfg.num_layers
    hyper = TrainHyper(peak_lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)

    class CountedData(SyntheticLMDataset):
        """The dataset, with the RM kernels' launch counts read at every
        ``batch_at`` (once a step, before it)."""
        marks = []

        def batch_at(self, step):
            self.marks.append({k: fn.launches for k, fn in counters.items()})
            return super().batch_at(step)

    data = CountedData(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH, seed=0, device="cuda")
    print(f"[train c] {cfg.name}: {layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, rm attention (fused: B2), compute "
          f"{cfg.compute_dtype}, fp32 masters, AdamW; SyntheticLMDataset "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step; depth cut from "
          f"{get_config('qwen3-1.7b').num_layers} to {layers}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(cfg, hyper, data, ckpt_dir=ckpt_dir, seed=0,
                          log_every=1, checkpoint_every=10 ** 9,
                          device="cuda")
        t0 = time.perf_counter()
        state = trainer.train(TRAIN_STEPS)
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        CountedData.marks.append({k: fn.launches
                                  for k, fn in counters.items()})
        peak = torch.cuda.max_memory_allocated()
        kernels["B2"]["train_peak_gib"] = peak / 2**30
        state_bytes = tree_bytes(state)
        rows = trainer.metrics_log
        marks = CountedData.marks
        per_step = [{k: marks[i + 1][k] - marks[i][k] for k in counters}
                    for i in range(TRAIN_STEPS)]
        want = {k: train_launches(cfg) if k == "B2" else 0
                for k in counters}
        walls = [row["sec_per_step"] for row in rows]
        for i, (row, launched) in enumerate(zip(rows, per_step)):
            finite = math.isfinite(row["loss"]) and math.isfinite(
                row["grad_norm"])
            if not (finite and launched == want):
                raise AssertionError(f"train c step {i}: loss "
                                     f"{row['loss']}, grad_norm "
                                     f"{row['grad_norm']}, launches "
                                     f"{launched} (want {want})")
        warm = statistics.median(walls[1:])
        tokens = TRAIN_BATCH * TRAIN_SEQ
        print(f"[train c] {TRAIN_STEPS} steps: ce "
              + " ".join(f"{row['ce']:.4f}" for row in rows)
              + f"; grad_norm " + " ".join(f"{row['grad_norm']:.3f}"
                                           for row in rows)
              + f"; every step B2 x {train_launches(cfg)} ({layers} "
              "forward, the rest the remat recompute), no other RM kernel")
        print(f"[train c] step wall: cold {walls[0] * 1e3:.1f} ms, warm "
              f"median {warm * 1e3:.1f} ms (min {min(walls[1:]) * 1e3:.1f}, "
              f"max {max(walls[1:]) * 1e3:.1f}) = {tokens / warm:.0f} "
              f"tokens/s; train() {train_wall:.2f}s, of which "
              f"{train_wall - sum(walls):.2f}s data, logging and the final "
              "checkpoint")
        print(f"[train c] peak device memory {peak / 2**30:.2f} GiB "
              f"(torch.cuda.max_memory_allocated) beside the train state "
              f"{state_bytes / 2**30:.2f} GiB (params, mu, nu fp32)")
        if not rows[-1]["ce"] < rows[0]["ce"]:
            raise AssertionError(f"train c: ce did not fall: "
                                 f"{rows[0]['ce']} -> {rows[-1]['ce']}")
        t0 = time.perf_counter()
        restored = trainer.ckpt.restore(device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        flat, back = flatten_dict(state), flatten_dict(restored)
        same = set(flat) == set(back) and all(
            back[key].dtype == leaf.dtype and torch.equal(back[key], leaf)
            for key, leaf in flat.items())
        print(f"[train c] checkpoint step {trainer.ckpt.latest_step()}: "
              f"{len(flat)} leaves restored bitwise {same} in "
              f"{restore_s:.2f}s")
        if not same:
            raise AssertionError("train c: the checkpoint did not restore "
                                 "bitwise")
        del restored, back
    kernels["B2"]["train_step_launches"] = train_launches(cfg)

    # where a warm step's time goes
    step_fn = make_train_step(cfg, hyper)
    batch = data.batch_at(TRAIN_STEPS)
    state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    t_enq = time.perf_counter()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    enq_ms = (t_enq - t0) * 1e3
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
    by_name, count = {}, 0
    bwd_ms = 0.0
    span = "rm_attention_fused_causal.backward"
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name == span:
            continue        # the span's device-side copy: not a kernel
        if e.device_type == DeviceType.CUDA:
            count += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
        elif e.name == span:
            bwd_ms += e.device_time_total / 1e3
    busy = sum(by_name.values())
    b2_ms = sum(ms for name, ms in by_name.items() if "chunk_" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"[train time] warm step (profiler off): wall {wall_ms:.1f} ms, "
          f"host enqueue {enq_ms:.1f} ms; profiled step: device busy "
          f"{busy:.1f} ms ({100 * busy / wall_ms:.0f}% of the wall, idle "
          f"{100 * (1 - busy / wall_ms):.0f}%), {count} device kernels; top "
          + "; ".join(f"{name[:56]} {ms:.2f} ms" for name, ms in top))
    print(f"[train time] B2 (forward, kernel) {b2_ms:.2f} ms device a step "
          f"({train_launches(cfg)} launches: forward and remat); its "
          "backward's recompute (the "
          f"rm_attention_fused_causal.backward spans) {bwd_ms:.2f} ms device "
          "a step ("
          + (f"{100 * bwd_ms / busy:.1f}% of device busy)" if busy else
             "the profiler kept no device event: not measured)"))
    # the same two at the step's shape alone, CUDA events over the layers
    dh = cfg.resolved_head_dim
    plan = rm_plan_for(cfg, dh)
    wq = pack_omegas(plan, init_omegas(plan, gen))
    cd, cs = plan_columns(plan, "cuda")
    bq = unit_rows(torch, (TRAIN_BATCH, cfg.num_heads, TRAIN_SEQ, dh), gen)
    bk = unit_rows(torch, (TRAIN_BATCH, cfg.num_heads, TRAIN_SEQ, dh), gen)
    bv = torch.randn(bq.shape, generator=gen, device="cuda")
    ones = torch.ones((TRAIN_BATCH, TRAIN_SEQ), device="cuda")
    fwd_ev = time_ms(torch, lambda: rm_fused_causal(bq, bk, bv, ones, wq, cd,
                                                    cs, 1e-4), iters=20)
    xs = [x.requires_grad_() for x in (bq, bk, bv)]

    def recompute():
        out = _fused_causal_formulation(*xs, ones, wq, cd, cs, 128, 1e-4)
        torch.autograd.grad(out, xs, torch.ones_like(out))

    bwd_ev = time_ms(torch, recompute, iters=20)
    print(f"[train time] at the step's shape (B {TRAIN_BATCH} x H "
          f"{cfg.num_heads}, T {TRAIN_SEQ}, d {dh}, F {wq.shape[1]}) alone: "
          f"B2 {fwd_ev:.3f} ms, the backward's recompute {bwd_ev:.3f} ms "
          f"a layer (CUDA events, 20 calls), x {layers} layers = "
          f"{fwd_ev * layers:.1f} / {bwd_ev * layers:.1f} ms a step")
    kernels["B2"]["train_step_device_ms"] = b2_ms
    kernels["B2"]["train_backward_device_ms"] = bwd_ms
    del state, metrics, batch, trainer, step_fn, xs, bq, bk, bv
    gc.collect()
    torch.cuda.empty_cache()

    # d. hubert-xlarge: one train step at full width and depth
    hlayers = hcfg.num_layers
    embeds = torch.randn((ENC_TRAIN_CLIPS, ENC_FRAMES, hcfg.d_model),
                         generator=gen, device="cuda")
    targets = torch.randint(0, hcfg.vocab_size,
                            (ENC_TRAIN_CLIPS, ENC_FRAMES), generator=gen,
                            device="cuda")
    hstate = init_train_state(hcfg, seed=0, hyper=hyper, device="cuda")
    hstep = make_train_step(hcfg, hyper)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k: fn.launches for k, fn in counters.items()}
    t0 = time.perf_counter()
    hstate, hm = hstep(hstate, {"embeds": embeds, "targets": targets})
    torch.cuda.synchronize()
    h_wall = time.perf_counter() - t0
    launched = {k: fn.launches - before[k] for k, fn in counters.items()}
    h_peak = torch.cuda.max_memory_allocated()
    finite = (math.isfinite(float(hm["loss"]))
              and math.isfinite(float(hm["grad_norm"]))
              and all(torch.isfinite(x).all()
                      for x in flatten_dict(hstate["params"]).values()))
    print(f"[train d] {hcfg.name}: {hlayers} layers, {ENC_TRAIN_CLIPS} clips "
          f"x {ENC_FRAMES} frames, framewise targets: loss "
          f"{float(hm['loss']):.4f}, grad_norm {float(hm['grad_norm']):.3f}, "
          f"finite {finite}; step wall {h_wall * 1e3:.1f} ms (cold), peak "
          f"{h_peak / 2**30:.2f} GiB beside the state "
          f"{tree_bytes(hstate) / 2**30:.2f} GiB; launches {launched}")
    want = {k: train_launches(hcfg) if k in ("B3", "B4") else 0
            for k in counters}
    if not (finite and launched == want):
        raise AssertionError(f"train d: finite {finite}, launches "
                             f"{launched} (want {want})")
    kernels["B3"]["train_step_launches"] = train_launches(hcfg)
    kernels["B4"]["train_step_launches"] = train_launches(hcfg)
    kernels["B3"]["train_peak_gib"] = h_peak / 2**30
    del hstate, hstep, embeds, targets
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] phase 24 in {time.perf_counter() - t_phase:.2f}s")


# -- phase 25: observability, restart recovery, exact attention ---------------
PHASE25_DIR = Path(__file__).resolve().parent / "smoke_out" / "phase25"
EXACT_TOL = 1e-4     # relative: fp32 exact paths card vs CPU, blockwise vs
#                      small (x max(1, max |small|)), sums of <= T terms
DRIFT_CUT = 16       # the budget cut the drift check must catch
DRIFT_SUP_TOL = 1e-5  # the drift check's sup error, card vs CPU


def step_walls(torch, engine, prompts, base):
    """Submit every prompt as a greedy 16-token request (ids ``base + i``)
    and step until drained; return the tokens by prompt id and the walls
    of the decode-only ticks (an active decode and no admission; each tick
    ends in the host read of the sampled tokens, so its wall is the
    card's too)."""
    from repro_torch.serve import Request

    for rid, prompt in prompts.items():
        engine.submit(Request(base + rid, prompt, max_new_tokens=16))
    torch.cuda.synchronize()
    walls = []
    while engine.pending():
        t0 = time.perf_counter()
        info = engine.step()
        dt = time.perf_counter() - t0
        if info.active and not info.admitted:
            walls.append(dt)
    return ({rid: engine.finished[base + rid].generated for rid in prompts},
            walls)


def decode_tick_syncs(torch, engine, prompts, base):
    """Synchronizing calls of one decode-only tick (``count_syncs``): four
    requests admitted by one tick, the next tick counted, then drained."""
    from repro_torch.serve import Request

    for rid in range(4):
        engine.submit(Request(base + rid, prompts[rid], max_new_tokens=4))
    engine.step()
    n = count_syncs(torch, engine.step)
    engine.run()
    return n


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def scope_cost(torch, n=2000):
    """The host's cost of one ``kernel_scope`` enter and exit around no
    work (µs, the mean of ``n``): with no tracer; with a tracer in memory;
    with a tracer streaming to a file (a JSON line and a flush a span);
    and ``torch.profiler.record_function`` alone."""
    from repro_torch.obs import Tracer, install_tracer, kernel_scope

    x = torch.zeros(1, device="cuda")
    cost = dict(batch=128, d=128, depth=5, f=163, itemsize=2)

    def per_span(body):
        body()
        t0 = time.perf_counter()
        body()
        return (time.perf_counter() - t0) / n * 1e6

    def scopes():
        for _ in range(n):
            with kernel_scope("rm_feature", x=x, cost=cost):
                pass

    def record_functions():
        for _ in range(n):
            with torch.profiler.record_function("repro.rm_feature"):
                pass

    out = {"none": per_span(scopes)}
    for label, path in (("memory", None),
                        ("file", PHASE25_DIR / "scope_cost.jsonl")):
        tracer = Tracer(path=path)
        prev = install_tracer(tracer)
        try:
            out[label] = per_span(scopes)
        finally:
            install_tracer(prev)
            tracer.close()
    out["record_function"] = per_span(record_functions)
    print(f"[obs] kernel_scope host cost a span: no tracer "
          f"{out['none']:.2f} us, tracer in memory {out['memory']:.2f} us, "
          f"tracer to a file {out['file']:.2f} us; record_function alone "
          f"{out['record_function']:.2f} us")
    return out


def obs_exact_phase(torch, np, kernels, counters, prompts, rm_tokens,
                    enc_rm_wall):
    """Phase 25 (see the module docstring): (a) the traced rm serve, (b)
    the drift check, (c) restart recovery, (d) exact qwen3, (e) exact
    hubert. Every check is fatal."""
    from repro_torch.configs import get_config
    from repro_torch.core.feature_map import RMFeatureMap
    from repro_torch.core.maclaurin import ExponentialDotProductKernel
    from repro_torch.launch.serve import make_engine
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer as tt
    from repro_torch.obs import (
        NOOP,
        DriftMonitor,
        Obs,
        install_tracer,
        read_trace,
    )
    from repro_torch.serve import Request, Scheduler
    from repro_torch.train.steps import (
        TrainHyper,
        init_params,
        init_train_state,
        make_prefill_step,
        make_train_step,
    )

    t_phase = time.perf_counter()
    cfg = get_config("qwen3-1.7b", attention_mode="rm")
    layers, dh = cfg.num_layers, cfg.resolved_head_dim

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def launched():
        return {kid: fn.launches for kid, fn in counters.items()
                if fn.launches}

    # a. the traced rm serve
    trace_path = PHASE25_DIR / "serve_trace.jsonl"
    obs = Obs(trace_path=trace_path, install_kernel_tracing=True)
    engine = make_engine("qwen3-1.7b", smoke=False, attention_mode="rm",
                         num_slots=4, max_len=256, seed=0, obs=obs,
                         device="cuda")
    zero()
    done, admissions, decode_steps, wall = run_workload(torch, engine,
                                                        prompts, 0)
    serve_launches = launched()
    records = read_trace(trace_path)
    meta = records[0]
    prov = meta.get("provenance", {})
    spans = [r for r in records if r.get("type") == "span"]
    fused = [r for r in spans if r["name"] == "kernel/rm_attn_fused"]
    feat = [r for r in spans if r["name"] == "kernel/rm_feature"]
    other = sorted({r["name"] for r in spans if r["name"].startswith(
        "kernel/")} - {"kernel/rm_attn_fused", "kernel/rm_feature"})
    lifecycles = {}
    for r in records:
        if r.get("type") == "event" and r["name"].startswith("request/"):
            lifecycles.setdefault(r["attrs"]["request_id"], []).append(
                r["name"])
    print(f"[obs] traced rm serve ({cfg.name}, {layers} layers, "
          f"Scheduler(obs=Obs(trace_path, install_kernel_tracing=True))): "
          f"{len(done)} requests in {wall:.3f}s, {admissions} admissions, "
          f"{decode_steps} decode steps, launches {serve_launches}; trace "
          f"{len(records)} records, {len(fused)} kernel/rm_attn_fused and "
          f"{len(feat)} kernel/rm_feature spans; meta provenance {prov}")
    if any(done[r].generated != rm_tokens[r] for r in prompts):
        raise AssertionError("traced serve's tokens differ from phase 7's")
    if not (meta.get("type") == "meta"
            and meta.get("schema") == "repro.obs.trace/v1"
            and prov.get("backend") == "cuda"
            and prov.get("device_kind") == torch.cuda.get_device_name(0)
            and prov.get("interpret") is False and "jax_version" in prov
            and prov.get("torch_version") == torch.__version__):
        raise AssertionError(f"trace meta header {meta}")
    want_cycle = ["request/submit", "request/admit", "request/finish"]
    if sorted(lifecycles) != sorted(prompts) or any(
            c != want_cycle for c in lifecycles.values()):
        raise AssertionError(f"request lifecycles {lifecycles}")
    if not (len(fused) == layers * admissions == serve_launches.get("B2")
            and len(feat) == layers * decode_steps
            == serve_launches.get("B1")
            and set(serve_launches) == {"B1", "B2"} and not other):
        raise AssertionError(
            f"kernel spans: {len(fused)} rm_attn_fused, {len(feat)} "
            f"rm_feature, others {other}; launches {serve_launches}")
    if not all(r["attrs"].get("flops", 0) > 0
               and r["attrs"].get("hbm_bytes", 0) > 0
               and r["attrs"].get("traced") is False for r in fused + feat):
        raise AssertionError("a kernel span lacks its flops / hbm_bytes")
    if len([r for r in spans if r["name"] == "decode/step"]) != \
            decode_steps or len([r for r in spans
                                 if r["name"] == "prefill"]) != admissions:
        raise AssertionError("decode/step or prefill spans miss a tick")
    kspan_us = [r["dur_us"] for r in feat]
    print(f"[obs] every request submit -> admit -> finish; spans equal the "
          f"launch counters (B2 {serve_launches['B2']} = {layers} x "
          f"{admissions} admissions, B1 {serve_launches['B1']} = {layers} x "
          f"{decode_steps} decode steps), each with flops and hbm_bytes; "
          f"a kernel/rm_feature span's host enqueue p50 "
          f"{median(kspan_us):.1f} us")
    obs.close()
    # warm decode-step walls on the same engine, the observability mode
    # changed every tick so that every mode meets the same host: off; an
    # in-memory Obs without kernel tracing; with it; the trace streamed
    # to a file
    modes = ("off", "metrics", "spans", "file")
    obs_of = {"off": NOOP, "metrics": Obs(), "spans": Obs(),
              "file": Obs(trace_path=PHASE25_DIR / "warm_trace.jsonl")}
    tracer_of = {"off": None, "metrics": None,
                 "spans": obs_of["spans"].tracer,
                 "file": obs_of["file"].tracer}
    walls = {m: [] for m in modes}
    tick = 0
    for rnd in range(4):
        base = 1000 * (rnd + 1)
        for rid, prompt in prompts.items():
            engine.submit(Request(base + rid, prompt, max_new_tokens=16))
        while engine.pending():
            mode = modes[tick % len(modes)]
            tick += 1
            engine.obs = obs_of[mode]
            prev = install_tracer(tracer_of[mode])
            t0 = time.perf_counter()
            try:
                info = engine.step()
            finally:
                install_tracer(prev)
            dt = time.perf_counter() - t0
            if info.active and not info.admitted:
                walls[mode].append(dt)
        if any(engine.finished[base + r].generated != rm_tokens[r]
               for r in prompts):
            raise AssertionError("a warm run with obs changed tokens")
    engine.obs = NOOP
    syncs = {"off": decode_tick_syncs(torch, engine, prompts, 8000)}
    engine.obs = obs_of["file"]
    prev = install_tracer(tracer_of["file"])
    try:
        syncs["file"] = decode_tick_syncs(torch, engine, prompts, 8500)
    finally:
        install_tracer(prev)
    engine.obs = NOOP
    for o in obs_of.values():
        o.close()
    if syncs["file"] != syncs["off"]:
        raise AssertionError(f"obs adds synchronizations: {syncs}")
    step_ms = {m: median(w_) * 1e3 for m, w_ in walls.items()}
    rm_step_ms = step_ms["off"]
    print(f"[obs] warm decode-step wall, the mode changed every tick "
          f"(median of {min(len(w_) for w_ in walls.values())}+ "
          "decode-only ticks each): " + ", ".join(
              f"{m} {ms:.2f} ms ({100 * (ms / rm_step_ms - 1):+.1f}%)"
              for m, ms in step_ms.items())
          + f"; synchronizing calls a decode tick: {syncs['file']} with "
          f"the traced obs, {syncs['off']} without")
    scope_cost(torch)
    kernels["B1"]["phase25_serve_launches"] = serve_launches["B1"]
    kernels["B2"]["phase25_serve_launches"] = serve_launches["B2"]

    # b. the drift check at qwen3's head
    rm = cfg.rm
    kern = ExponentialDotProductKernel(rm.sigma2)
    zero()
    mon = DriftMonitor.for_estimator(kern, dh, rm.num_features,
                                     estimator="rm", measure=rm.measure,
                                     device="cuda")
    rep = mon.check()
    torch.cuda.synchronize()
    full_launches = launched()
    cpu_map = RMFeatureMap(plan=mon.fm.plan, omegas=mon.fm.omegas.cpu())
    rep_cpu = DriftMonitor(cpu_map, kern, measure=rm.measure).check()
    zero()
    cut = DriftMonitor.for_estimator(kern, dh, rm.num_features // DRIFT_CUT,
                                     estimator="rm", measure=rm.measure,
                                     device="cuda")
    # the cut map held to the deployed map's calibrated envelope: twice the
    # deployed map's own sup error
    cut.margin = 2.0 * rep.sup_err / cut.eps_bound()
    rep_cut = cut.check()
    torch.cuda.synchronize()
    cut_launches = launched()
    print(f"[drift] rm at d {dh}, D {rm.num_features} (F "
          f"{rep.num_features}): sup_err {rep.sup_err:.4f} (CPU "
          f"{rep_cpu.sup_err:.4f}) vs eps_bound {rep.eps_bound:.4f} over "
          f"{rep.n_pairs} pairs: {'ok' if rep.ok else 'VIOLATION'}, "
          f"launches {full_launches}; cut to D/{DRIFT_CUT} (F "
          f"{rep_cut.num_features}): sup_err {rep_cut.sup_err:.4f} vs the "
          f"envelope {2.0 * rep.sup_err:.4f}: "
          f"{'ok' if rep_cut.ok else 'fires'}, launches {cut_launches}; "
          f"recommend {cut.recommend()}")
    if not (rep.ok and not rep_cut.ok and full_launches == {"B1": 1}
            and cut_launches == {"B1": 1}
            and abs(rep.sup_err - rep_cpu.sup_err) <= DRIFT_SUP_TOL):
        raise AssertionError("drift check failed")
    kernels["B1"]["phase25_drift_launches"] = 2
    del mon, cut, cpu_map

    # c. restart recovery on the same engine
    orig = engine.executor.decode
    calls = {"n": 0, "fail": 3}

    def flaky(tokens, positions):
        calls["n"] += 1
        if calls["n"] == calls["fail"]:
            raise RuntimeError("injected decode failure")
        return orig(tokens, positions)

    engine.executor.decode = flaky
    engine.max_restarts, engine.restarts = 1, 0
    done_r, adm_r, _, _ = run_workload(torch, engine, prompts, 20000)
    toks_r = {rid: s.generated for rid, s in done_r.items()}
    readmitted = sum(s.admissions > 1 for s in done_r.values())
    print(f"[restart] decode failure injected at decode call "
          f"{calls['fail']}, max_restarts 1: {engine.restarts} restart, "
          f"{adm_r} admissions ({readmitted} requests re-admitted), every "
          "request finished with phase 7's tokens: "
          f"{toks_r == rm_tokens}")
    if not (engine.restarts == 1 and readmitted and toks_r == rm_tokens):
        raise AssertionError("restart recovery failed")
    engine.max_restarts, engine.restarts = 0, 0
    calls.update(n=0, fail=1)
    for rid, prompt in prompts.items():
        engine.submit(Request(21000 + rid, prompt, max_new_tokens=16))
    try:
        engine.run()
    except RuntimeError as e:
        print(f"[restart] max_restarts 0: the failure propagates ({e})")
    else:
        raise AssertionError("max_restarts=0 did not raise")
    engine.executor.decode = orig
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # d. exact attention: qwen3 SMOKE card vs CPU
    small = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                                compute_dtype="float32")
    assert small.attention_mode == "exact"
    p_cpu = tt.init_model(small, torch.Generator().manual_seed(0))
    p_gpu = tree_to(p_cpu, "cuda")
    rng = np.random.default_rng(25)
    toks = torch.from_numpy(rng.integers(0, small.vocab_size, size=(2, 24)))
    zero()
    with torch.inference_mode():
        lg_gpu, _ = tt.forward(p_gpu, small, {"tokens": toks.cuda()})
        lg_cpu, _ = tt.forward(p_cpu, small, {"tokens": toks})
    rel = rel_err(torch, lg_gpu, lg_cpu)
    small_prompts = {rid: rng.integers(0, small.vocab_size, size=n)
                     for rid, n in enumerate((3, 17, 33, 40))}
    got = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        sched = Scheduler(small, params, num_slots=2, max_len=64,
                          device=dev)
        for rid, prompt in small_prompts.items():
            sched.submit(Request(rid, prompt, max_new_tokens=12))
        got[dev] = {rid: s.generated for rid, s in sched.run().items()}
    print(f"[exact small] qwen3 SMOKE exact fp32, card vs CPU: logits rel "
          f"err {rel:.2e} (tol {EXACT_TOL:.0e}), greedy tokens of "
          f"{len(small_prompts)} requests identical: "
          f"{got['cuda'] == got['cpu']}; RM launches {launched()}")
    if not (rel <= EXACT_TOL and got["cuda"] == got["cpu"]
            and not launched()):
        raise AssertionError("exact SMOKE card vs CPU failed")
    hyper = TrainHyper(peak_lr=1e-3, warmup_steps=1, total_steps=8)
    tb = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    st_cpu = init_train_state(small, seed=3, hyper=hyper, device="cpu")
    st_gpu = tree_to(st_cpu, "cuda")
    _, m_cpu = make_train_step(small, hyper)(st_cpu, tb)
    _, m_gpu = make_train_step(small, hyper)(st_gpu, tree_to(tb, "cuda"))
    gaps = {key: abs(float(m_gpu[key]) - float(m_cpu[key]))
            / abs(float(m_cpu[key])) for key in ("loss", "grad_norm")}
    print(f"[exact small] one exact SMOKE train step card vs CPU: loss "
          f"{gaps['loss']:.2e}, grad_norm {gaps['grad_norm']:.2e} relative "
          f"(tol {TRAIN_METRIC_TOL:.0e})")
    if not all(x <= TRAIN_METRIC_TOL for x in gaps.values()):
        raise AssertionError("exact SMOKE train step card vs CPU failed")
    del p_gpu, p_cpu, st_cpu, st_gpu

    # the blockwise path (a 4096-token prompt) against the small one
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    t_long, h = 4096, cfg.num_heads
    q, k, v = (torch.randn((1, t_long, h, dh), generator=gen, device="cuda")
               for _ in range(3))
    pos = torch.arange(t_long, device="cuda", dtype=torch.int32)[None]
    ccfg = get_config("qwen3-1.7b")
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blk = attn_mod._softmax_attention(ccfg, q, k, v, pos, pos)
        torch.cuda.synchronize()
        blk_ms = (time.perf_counter() - t0) * 1e3
        small_out = attn_mod._softmax_attention_small(ccfg, q, k, v, pos,
                                                      pos)
    err = ((blk - small_out).abs().max()
           / small_out.abs().max().clamp_min(1.0)).item()
    print(f"[exact] {t_long}-token causal prompt, {h} heads, fp32: the "
          f"blockwise path ({blk_ms:.1f} ms) vs the small one: err "
          f"{err:.2e} x max(1, max |small|) (tol {EXACT_TOL:.0e})")
    if not err <= EXACT_TOL:
        raise AssertionError("blockwise exact attention differs from small")
    del q, k, v, blk, small_out

    # qwen3-1.7b exact at full width, phase 7's workload
    ecfg = get_config("qwen3-1.7b", attention_mode="exact")
    engine = make_engine("qwen3-1.7b", smoke=False, attention_mode="exact",
                         num_slots=4, max_len=256, seed=0, device="cuda")
    if engine.estimator is not None or engine.fused_attention:
        raise AssertionError("the exact engine reports an estimator")
    serve_slice(torch, "exact slice", engine, ecfg, prompts, counters,
                lambda adm, steps: {kid: 0 for kid in counters})
    _, walls_exact = step_walls(torch, engine, prompts, 5000)
    exact_step_ms = median(walls_exact) * 1e3
    kv_gb = sum(t_.numel() * t_.element_size()
                for lay in engine.executor.cache["layers"]
                for t_ in lay.values()) / 2**30
    print(f"[exact] warm decode-step wall (median of {len(walls_exact)} "
          f"decode-only ticks): exact {exact_step_ms:.2f} ms beside rm "
          f"{rm_step_ms:.2f} ms; the KV ring buffers {kv_gb:.3f} GiB "
          "(4 lanes x 256 positions)")
    # where the exact slice's time goes, as phase 8 reads the rm slice's
    where_time_goes(torch, "exact", engine, prompts,
                    {rid: engine.finished[5000 + rid] for rid in prompts})
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # e. hubert-xlarge exact at full width
    hcfg = get_config("hubert-xlarge", attention_mode="exact")
    master = init_params(hcfg, seed=0)
    hparams = tt.cast_params_to_compute(master, hcfg)
    del master
    hgen = torch.Generator(device="cuda")
    hgen.manual_seed(1)
    embeds = torch.randn((ENC_CLIPS, ENC_FRAMES, hcfg.d_model),
                         generator=hgen, device="cuda").to(torch.bfloat16)
    encode = make_prefill_step(hcfg, hcfg.max_seq_len)
    zero()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = encode(hparams, {"embeds": embeds})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    finite = bool(torch.isfinite(logits).all())
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    del logits

    def encode_once():
        encode(hparams, {"embeds": embeds})

    busy_ms, by_name, count, _ = device_profile(torch, encode_once)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    print(f"[exact enc time] encode {ENC_CLIPS} x {ENC_FRAMES}: wall "
          f"{1e3 * walls[1]:.2f} ms, device busy {busy_ms:.2f} ms ("
          f"{100 * busy_ms / (1e3 * walls[1]):.0f}%, idle "
          f"{100 * (1 - busy_ms / (1e3 * walls[1])):.0f}%), {count} device "
          "kernels; top kernels " + "; ".join(
              f"{name[:56]} {ms:.3f} ms" for name, ms in top))
    logits, _ = encode(hparams, {"embeds": embeds})
    print(f"[exact enc] {hcfg.name} exact ({hcfg.num_layers} layers, bf16) "
          f"{ENC_CLIPS} x {ENC_FRAMES} frames: walls "
          f"{1e3 * walls[0]:.2f} / {1e3 * walls[1]:.2f} ms (first cold) "
          f"beside phase 13's rm warm {1e3 * enc_rm_wall:.2f} ms; peak "
          f"memory {peak_gb:.2f} GiB; logits {tuple(logits.shape)} finite "
          f"{finite}; RM launches {launched()}")
    if not (finite and logits.shape == (ENC_CLIPS, ENC_FRAMES,
                                        hcfg.vocab_size)
            and not launched()):
        raise AssertionError("exact hubert encode failed")
    del hparams, embeds, logits
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[exact] phase 25 in {time.perf_counter() - t_phase:.2f}s")


# -- phase 26: adaptive accuracy; MLA and MoE (deepseek-v2-lite-16b) ----------
PHASE26_DIR = Path(__file__).resolve().parent / "smoke_out" / "phase26"
GROW_TOL = 1e-5      # x max(1, max |cpu|): the growable map card vs CPU, and
#                      its Gram against the concatenation's (fp32 sums of
#                      <= 10 x 64 products; Grams of <= 8 x 163 features)
# BENCH_core.json's three shapes: (name, kernel, d, F, batch)
CORE_SHAPES = (("exp_d64_F256_b1024", "exp", 64, 256, 1024),
               ("poly7_d32_F512_b512", "poly7", 32, 512, 512),
               ("exp_d24_F192_b512", "exp", 24, 192, 512))
TIERS = {"low": 1, "standard": 2, "high": 4}
DEEPSEEK = "deepseek-v2-lite-16b"


def b1_shape_check(torch, np, gen, w32, cd, cs, rows, tag, profile=True):
    """B1 at a model's decode shape (x ``[rows, d]``, q and k of every lane
    and head stacked) against its plain version, fp32 and bf16, with times
    and bounds; returns the fp32 figures (``shape``, ``max_abs_err``,
    ``ms``, ``device_ms``, ``plain_ms``, ``bound_ms``, ``bound_by``).
    ``profile``: whether to take the kernel's device time in a profiler
    window (``device_ms`` None without)."""
    from repro_torch.kernels.rm_feature.ops import rm_feature_fused
    from repro_torch.kernels.rm_feature.ref import rm_feature_fused_ref

    d, f = w32.shape[2], w32.shape[1]
    c_np = cd.cpu().numpy()
    record = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = unit_rows(torch, (rows, d), gen).to(dtype)
        w = w32.to(dtype)
        got = rm_feature_fused(x, w, cd, cs)
        again = rm_feature_fused(x, w, cd, cs)
        want = rm_feature_fused_ref(x, w, cd, cs)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = B1_TOL * max(1.0, want.abs().max().item())
        same = torch.equal(got, again)
        ms = time_ms(torch, lambda: rm_feature_fused(x, w, cd, cs))
        dev_ms = kernel_device_ms(torch, lambda: rm_feature_fused(
            x, w, cd, cs), "rm_feature_kernel") if profile else None
        plain_ms = time_ms(torch, lambda: rm_feature_fused_ref(x, w, cd, cs),
                           iters=10)
        dname = str(dtype).split(".")[-1]
        item = x.element_size()
        nbytes = rows * d * item + omega_bytes(c_np, d, item) + f * 8 \
            + rows * f * 4
        tcms, tcby = tensor_core_bound(nbytes, featurize_ops(rows, c_np, d),
                                       0, dname, True)
        print(f"[{tag} B1] decode x[{rows},{d}] F {f} {dname}: max_abs_err "
              f"{err:.3e} (tol {tol:.1e}), two calls bitwise equal {same}; "
              f"kernel {device_text(dev_ms)}{ms:.4f} ms events; plain "
              f"{plain_ms:.4f} ms; bound {tcms:.6f} ms ({tcby}, tensor "
              "cores)")
        if not (err <= tol and same):
            raise AssertionError(f"B1 at {tag}'s decode shape {dname}: "
                                 f"error {err} > {tol} or two calls differ")
        if dtype == torch.float32:
            record = dict(shape=f"x[{rows},{d}] fp32, F {f}",
                          max_abs_err=err, ms=ms, device_ms=dev_ms,
                          plain_ms=plain_ms, bound_ms=tcms, bound_by=tcby)
    return record


def b2_shape_check(torch, np, gen, w32, cd, cs, heads, dv, eps, t, pad,
                   tag, profile=True):
    """B2 at a model's prefill (one prompt's ``heads`` heads, q/k width of
    ``w32``, values ``dv``, T ``t`` with the last ``pad`` keys padded)
    against its plain version: fp32 within the 3xTF32 gate, bf16 within
    B2_TOL, two calls bitwise equal, with times and bounds; returns the
    fp32 figures (the keys and ``profile`` of :func:`b1_shape_check`)."""
    from repro_torch.kernels.rm_attention.ops import rm_fused_causal
    from repro_torch.kernels.rm_attention.ref import rm_fused_causal_ref

    d, f = w32.shape[2], w32.shape[1]
    c_np = cd.cpu().numpy()
    record = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = unit_rows(torch, (1, heads, t, d), gen).to(dtype)
        k = unit_rows(torch, (1, heads, t, d), gen).to(dtype)
        v = torch.randn((1, heads, t, dv), generator=gen, device="cuda")
        kvalid = torch.ones((1, t), device="cuda")
        kvalid[0, t - pad:] = 0.0
        args = (q, k, v, kvalid, w32.to(dtype), cd, cs)
        got = rm_fused_causal(*args, eps)
        again = rm_fused_causal(*args, eps)
        want = rm_fused_causal_ref(*args, chunk=128, eps=eps)
        torch.cuda.synchronize()
        dname = str(dtype).split(".")[-1]
        gate = B2_FP32_TOL if dtype == torch.float32 else B2_TOL
        errs = []
        for name, g_, w_ in zip(("out", "S", "n"), got, want):
            scale_ = max(1.0, w_.abs().max().item())
            errs.append((g_ - w_).abs().max().item() / scale_)
            if not (errs[-1] <= gate and torch.isfinite(g_).all()):
                raise AssertionError(f"B2 at {tag}'s T {t} {name} {dname}: "
                                     f"error {errs[-1]:.2e} > {gate}")
        if not all(torch.equal(g_, a_) for g_, a_ in zip(got, again)):
            raise AssertionError(f"B2 at {tag}'s T {t} {dname}: two calls "
                                 "differ")
        sched = rm_fused_causal.last_schedule
        ms = time_ms(torch, lambda: rm_fused_causal(*args, eps), iters=20)
        dev_ms = kernel_device_ms(torch, lambda: rm_fused_causal(*args, eps),
                                  "chunk_", iters=20) if profile else None
        plain_ms = time_ms(torch, lambda: rm_fused_causal_ref(
            *args, chunk=128, eps=eps), iters=10)
        bh, item = heads, q.element_size()
        nbytes = (2 * bh * t * d * item + bh * t * dv * 4 + t * 4
                  + omega_bytes(c_np, d, item) + f * 8 + bh * t * dv * 4
                  + bh * f * dv * 4 + bh * f * 4)
        feat_ops = (featurize_ops(bh * t, c_np, d)
                    + featurize_ops(bh * (t - pad), c_np, d))
        other_ops = bh * t * (4 * f * dv + 3 * f + dv)
        tcms, tcby = tensor_core_bound(nbytes, feat_ops, other_ops, dname,
                                       True)
        print(f"[{tag} B2] prefill q,k[{bh},{t},{d}] v dv {dv} F {f} ({pad} "
              f"keys padded) {dname}: err out/S/n {errs[0]:.2e}/"
              f"{errs[1]:.2e}/{errs[2]:.2e} x max(1, max |plain|) (gate "
              f"{gate:.0e}), two calls bitwise equal; kernel "
              f"{device_text(dev_ms)}{ms:.4f} ms events; plain "
              f"{plain_ms:.4f} ms; bound {tcms:.5f} ms ({tcby}, tensor "
              f"cores); grid pass A {sched.blocks_a} + pass B "
              f"{sched.blocks_b} blocks")
        if dtype == torch.float32:
            record = dict(shape=f"q,k[{bh},{t},{d}] v[{bh},{t},{dv}] fp32, "
                                f"F={f}",
                          max_abs_err=max(errs), ms=ms, device_ms=dev_ms,
                          plain_ms=plain_ms, bound_ms=tcms, bound_by=tcby)
    return record


def device_text(dev_ms):
    """A shape check's device time for its line ("" where not taken)."""
    return "" if dev_ms is None else f"{dev_ms:.4f} ms device (profiler), "


def prefixed(prefix, record):
    """``record``'s keys under ``prefix_`` (a model's figures in the
    kernels line)."""
    return {f"{prefix}_{k}": v for k, v in record.items()}


def adaptive_mla_phase(torch, np, kernels, counters, prompts, rm_tokens):
    """Phase 26 (see the module docstring): (a) the growable map, (b)
    selection priced by the card, (c) accuracy tiers, (d) deepseek-v2-
    lite-16b. Every check is fatal."""
    import contextlib
    import io

    from repro_torch.common.dtypes import resolve_precision
    from repro_torch.configs import get_config
    from repro_torch.core import (
        CostModel,
        ExponentialDotProductKernel,
        make_feature_map,
        make_growable_feature_map,
        registry,
        select_budget,
    )
    from repro_torch.core.plan import init_omegas, pack_omegas, plan_columns
    from repro_torch.core.select import make_kernel
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.serve import make_engine
    from repro_torch.models.attention import rm_plan_for
    from repro_torch.models.mla import mla_qk_dim
    from repro_torch.obs import DriftMonitor
    from repro_torch.serve import Request

    t_phase = time.perf_counter()
    PHASE26_DIR.mkdir(parents=True, exist_ok=True)

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def launched():
        return {kid: fn.launches for kid, fn in counters.items()
                if fn.launches}

    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)

    # a. the growable map: exp at d 64, 256 features a generation, G 1-8
    kern = ExponentialDotProductKernel(1.0)
    gm = make_growable_feature_map(kern, 64, 0, base_features=256,
                                   measure="proportional", device="cuda")
    X = unit_rows(torch, (512, 64), gen) * 0.9
    maps, raws, grow_launches = [gm], [], []
    for _ in range(3):
        maps.append(maps[-1].grow())
    for m in maps:
        zero()
        raws.append(m.apply(X, rescale=False))
        torch.cuda.synchronize()
        grow_launches.append(launched())
    prefix = all(torch.equal(raws[i + 1][:, :raws[i].shape[1]], raws[i])
                 for i in range(3))
    path_indep = torch.equal(gm.grow_to_generations(4).apply(
        X, rescale=False), raws[2])
    g8 = maps[3]
    z_card = g8.apply(X)
    z_cpu = g8.to("cpu").apply(X.cpu())
    err_cpu = (z_card.cpu() - z_cpu).abs().max().item()
    tol_cpu = GROW_TOL * max(1.0, z_cpu.abs().max().item())
    zero()
    gram = g8.estimate_gram(X)
    torch.cuda.synchronize()
    gram_launches = launched()
    concat = z_card @ z_card.T
    err_gram = (gram - concat).abs().max().item()
    tol_gram = GROW_TOL * max(1.0, concat.abs().max().item())
    print(f"[grow] exp d 64, {gm.generation_output_dim} columns a "
          f"generation (base 256), G 1 -> 2 -> 4 -> 8 on the card: raw "
          f"prefix bitwise equal across each growth {prefix}, 1 -> 4 equal "
          f"to 1 -> 2 -> 4 {path_indep}; B1 launches an apply "
          f"{[lc.get('B1', 0) for lc in grow_launches]}; G 8 card vs CPU "
          f"(the same draws) max_abs_err {err_cpu:.3e} (tol {tol_cpu:.1e}); "
          f"estimate_gram vs the concatenation's Gram {err_gram:.3e} (tol "
          f"{tol_gram:.1e}), launches {gram_launches}")
    if not (prefix and path_indep and err_cpu <= tol_cpu
            and err_gram <= tol_gram
            and grow_launches == [{"B1": 2 ** i} for i in range(4)]
            and gram_launches == {"B1": 8}):
        raise AssertionError("growable map on the card failed")
    # the drift loop: the deployed map (G 8) sets an absolute envelope of
    # twice its own sup error; a map at D/16 is checked, grown and rebound
    # until it is inside
    dep = DriftMonitor(g8, kern, measure="proportional").check()
    envelope = 2.0 * dep.sup_err
    small = make_growable_feature_map(kern, 64, 1, base_features=2048 // 16,
                                      measure="proportional", device="cuda")
    mon = DriftMonitor(small, kern, measure="proportional")
    reports, drift_launches, gens = [], [], []
    zero()
    for _ in range(7):
        mon.margin = envelope / mon.eps_bound()
        before = counters["B1"].launches
        reports.append(mon.check())
        drift_launches.append(counters["B1"].launches - before)
        gens.append(mon.fm.n_generations)
        if reports[-1].ok:
            break
        rec = mon.recommend()
        mon.rebind(mon.fm.grow_to(rec.num_features_target))
    bounds = [r.eps_bound for r in reports]
    print(f"[grow drift] deployed G 8 (F {dep.num_features}): sup_err "
          f"{dep.sup_err:.4f}, envelope {envelope:.4f}; from D/16: "
          + "; ".join(f"F {r.num_features}: sup_err {r.sup_err:.4f} bound "
                      f"{r.eps_bound:.4f} {'ok' if r.ok else 'fires'}"
                      for r in reports)
          + f"; B1 launches a check {drift_launches} (the generations "
          f"{gens})")
    if not (not reports[0].ok and reports[-1].ok
            and all(b < a for a, b in zip(bounds, bounds[1:]))
            and drift_launches == gens):
        raise AssertionError("the drift -> grow -> rebind loop failed")
    del maps, raws, g8, z_card, z_cpu, gram, concat, small, mon

    # b. selection priced by the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    payload = {"schema_version": 2, "backend": "gpu", "interpret": False,
               "provenance": {"device_kind": torch.cuda.get_device_name(0),
                              "nvidia_smi": smi,
                              "torch_version": torch.__version__,
                              "source": "chip_smoke.py phase 26"},
               "precisions": ["fp32", "bf16"],
               "estimators": list(registry.list_estimators()),
               "results": {}}
    for name, kname, d, f_budget, batch in CORE_SHAPES:
        x = torch.randn((batch, d), generator=gen, device="cuda") * 0.2
        cells = {}
        for est in registry.list_estimators():
            fm = make_feature_map(make_kernel(kname), d, f_budget, seed=0,
                                  estimator=est, measure="proportional",
                                  device="cuda")
            entry = registry.get(est)
            for prec in ("fp32", "bf16"):
                packed = entry.pack(fm.plan, fm.params,
                                    resolve_precision(prec).compute_dtype)

                def featurize(fm=fm, entry=entry, prec=prec, packed=packed):
                    return entry.apply(fm.plan, fm.params, x, precision=prec,
                                       packed=packed)

                ms = time_ms(torch, featurize)
                cells[f"{est}/{prec}"] = {
                    "output_dim": fm.output_dim, "fused_us": ms * 1e3,
                    "fused_feats_per_s": batch * fm.output_dim / (ms * 1e-3)}
        payload["results"][name] = {"kernel": kname, "d": d, "F": f_budget,
                                    "batch": batch, "cells": cells}
        print(f"[select] {name}: fused featurize on the card, features/s "
              + ", ".join(f"{k} {c['fused_feats_per_s']:.3e}"
                          for k, c in cells.items()))
    bench_path = PHASE26_DIR / "bench_core_gpu.json"
    bench_path.write_text(json.dumps(payload, indent=1))
    cost = CostModel.from_file(bench_path)
    missing = cost.missing_cells(registry.list_estimators(), ["fp32", "bf16"])
    decisions = []
    for eps, delta in ((0.25, 0.05), (0.1, 0.01)):
        dec = select_budget(make_kernel("exp"), 64, eps, delta,
                            cost_model=cost, platform="gpu",
                            measure="proportional", radius=0.7, batch=1024)
        decisions.append(dec)
        print(f"[select] exp d 64 at (eps {eps}, delta {delta}): "
              f"{dec.estimator}/{dec.precision} D={dec.num_features} "
              f"certifies eps {dec.eps_certified:.4f}, predicted featurize "
              f"{dec.predicted_latency_s * 1e3:.3f} ms a 1024-row batch "
              f"(backend {dec.backend})")
    try:
        select_budget(make_kernel("exp"), 64, 0.25, 0.05, cost_model=cost,
                      platform="tpu")
        guard = False
    except ValueError:
        guard = True
    out = io.StringIO()
    zero()
    with contextlib.redirect_stdout(out):
        serve_main(["--arch", "qwen3-1.7b", "--smoke", "--eps", "1.0",
                    "--delta", "0.1", "--bench", str(bench_path),
                    "--requests", "2", "--max-new", "4", "--device", "cuda"])
    torch.cuda.synchronize()
    cli = out.getvalue()
    cli_launches = launched()
    print("[select] launch/serve.py --smoke --eps 1.0 --delta 0.1 --bench "
          f"<the card's payload>: launches {cli_launches}\n"
          + "\n".join("    " + ln for ln in cli.splitlines()))
    if not (not missing and cost.backend == "gpu" and not cost.interpret
            and guard and all(dd.eps_certified <= dd.eps
                              and dd.predicted_latency_s is not None
                              for dd in decisions)
            and "priced on backend gpu" in cli and "2 requests" in cli
            and cli_launches):
        raise AssertionError(f"selection priced by the card failed "
                             f"(missing cells {missing})")

    # c. accuracy tiers on phase 7's workload
    cfg = get_config("qwen3-1.7b", attention_mode="rm")
    engine = make_engine("qwen3-1.7b", smoke=False, attention_mode="rm",
                         num_slots=4, max_len=256, seed=0, device="cuda",
                         accuracy_tiers=TIERS)
    names = sorted(TIERS)
    zero()
    for rid, prompt in prompts.items():
        engine.submit(Request(rid, prompt, max_new_tokens=16,
                              accuracy_tier=names[rid % len(names)]))
    admissions = steps = 0
    while engine.pending():
        info = engine.step()
        admissions += len(info.admitted)
        steps += info.active > 0
    torch.cuda.synchronize()
    tier_launches = launched()
    done = engine.finished
    per_gen = cfg.rm.num_features // max(TIERS.values())
    want_feat = {rid: TIERS[names[rid % len(names)]] * per_gen
                 for rid in prompts}
    got_feat = {rid: done[rid].tier_features for rid in prompts}
    same = all(done[rid].generated == rm_tokens[rid] for rid in prompts)
    print(f"[tiers] qwen3-1.7b rm, accuracy_tiers {TIERS} on phase 7's "
          f"workload: tokens bitwise phase 7's {same}; tier_features "
          f"{got_feat} (want {want_feat}); launches {tier_launches} "
          f"({admissions} admissions, {steps} decode steps)")
    if not (same and got_feat == want_feat and tier_launches == {
            "B1": cfg.num_layers * steps, "B2": cfg.num_layers * admissions}):
        raise AssertionError("the tiered serve failed")
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # d. deepseek-v2-lite-16b: the SMOKE config card vs CPU in three modes
    for label, mode, fuse, want_kinds in (
            ("rm fused", "rm", "auto", {"B2"}),
            ("rm two-launch", "rm", "off", {"B1", "B5"}),
            ("exact", "exact", None, set())):
        smoke_card_vs_cpu(torch, np, counters, label, DEEPSEEK, mode, fuse,
                          want_kinds, False)

    # B2 and B1 at the MLA width (q/k 128 nope + 64 rope = 192, values 128)
    cfg = get_config(DEEPSEEK, attention_mode="rm")
    qk, dv, heads = mla_qk_dim(cfg), cfg.mla.v_head_dim, cfg.num_heads
    plan = rm_plan_for(cfg, qk)
    w32 = pack_omegas(plan, init_omegas(plan, gen))
    cd, cs = plan_columns(plan, "cuda")
    print(f"[ds plan] {cfg.name} rm at the MLA width {qk} (values {dv}): "
          f"packed w {tuple(w32.shape)}, F={plan.output_dim} columns at a "
          f"budget of {cfg.rm.num_features}, degrees "
          f"{np.bincount(plan.column_degrees()).tolist()}")
    kernels["B2"].update(prefixed("deepseek", b2_shape_check(
        torch, np, gen, w32, cd, cs, heads, dv, cfg.rm.eps, 256, 56, "ds")))
    kernels["B1"].update(prefixed("deepseek", b1_shape_check(
        torch, np, gen, w32, cd, cs, 2 * 4 * heads, "ds")))
    del w32

    # the full-width serve: bf16 weights drawn on the card from seed 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = make_engine(DEEPSEEK, smoke=False, attention_mode="rm",
                         num_slots=4, max_len=256, seed=0, device="cuda",
                         param_dtype="bfloat16")
    torch.cuda.synchronize()
    ready_s = time.perf_counter() - t0

    n_params = sum(p_.numel() for p_ in tree_leaves(engine.executor.params))
    p_bytes = sum(p_.numel() * p_.element_size()
                  for p_ in tree_leaves(engine.executor.params))
    state_bytes = sum(t_.numel() * t_.element_size()
                      for t_ in tree_leaves(engine.executor.cache))
    print(f"[ds] {cfg.name}: {cfg.num_layers} layers (first dense, d_ff "
          f"{cfg.d_ff}), d_model {cfg.d_model}, {heads} heads, MLA kv_lora "
          f"{cfg.mla.kv_lora_rank}, {cfg.moe.num_experts} routed experts "
          f"top-{cfg.moe.top_k} + {cfg.moe.num_shared_experts} shared (d_ff "
          f"{cfg.moe.d_ff_expert}), rm attention (F {plan.output_dim}); "
          f"depth cut: none; {n_params / 1e9:.2f} B parameters, "
          f"{p_bytes / 2**30:.2f} GiB in bf16, ready in {ready_s:.2f}s; "
          f"decode state {state_bytes / 2**20:.1f} MiB (4 lanes x "
          f"{cfg.num_layers} layers x rm_s [{heads}, {plan.output_dim}, "
          f"{dv}] + rm_n, fp32)")
    # phase 7's workload (the same lengths, so buckets 32-256) with token
    # ids drawn from deepseek's vocabulary
    done, ds_launches, admissions, steps, ds_prompts = serve_full_width(
        torch, np, "ds", engine, cfg, prompts, counters)
    if ds_launches != {"B1": cfg.num_layers * steps,
                       "B2": cfg.num_layers * admissions}:
        raise AssertionError(f"deepseek launches {ds_launches}: want B2 "
                             f"{cfg.num_layers} a prefill, B1 "
                             f"{cfg.num_layers} a decode step")
    kernels["B1"]["deepseek_launches"] = ds_launches["B1"]
    kernels["B2"]["deepseek_launches"] = ds_launches["B2"]
    shares = where_time_goes(
        torch, "deepseek", engine, ds_prompts, done,
        families={"B1": ("rm_feature_kernel",), "B2": ("chunk_",)})
    kernels["B1"]["deepseek_decode_step_device_ms"] = \
        shares["decode step"]["B1"]
    kernels["B2"]["deepseek_prefill_256_device_ms"] = \
        shares["prefill bucket 256"]["B2"]
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[ds] phase 26 in {time.perf_counter() - t_phase:.2f}s")


# -- phase 27: the SSM mixers (jamba-v0.1-52b, xlstm-350m); the last configs --
JAMBA = "jamba-v0.1-52b"
XLSTM = "xlstm-350m"
JAMBA_DEPTH = 8            # one pattern period of the 32 layers: one card
JAMBA_PREFILL_T = (5, 37, 200)   # exact-length prompts: no bucket
# (label, arch, attention mode or None for the config's own, fuse, the
# kernels its forward must launch, precomputed embeddings before tokens)
SMOKE_CASES = (
    ("jamba rm fused", JAMBA, "rm", "auto", {"B2"}, False),
    ("jamba rm two-launch", JAMBA, "rm", "off", {"B1", "B5"}, False),
    ("jamba exact", JAMBA, "exact", None, set(), False),
    ("xlstm", XLSTM, None, None, set(), False),
    ("olmo rm", "olmo-1b", "rm", "auto", {"B2"}, False),
    ("danube rm", "h2o-danube-3-4b", "rm", "auto", {"B2"}, False),
    ("qwen2 rm", "qwen2-7b", "rm", "auto", {"B2"}, False),
    ("internvl2 rm", "internvl2-1b", "rm", "auto", {"B2"}, True),
)


def smoke_card_vs_cpu(torch, np, counters, label, arch, mode, fuse,
                      want_kinds, embeds):
    """One SMOKE config in fp32, the same weights on the card and the CPU:
    logits within E2E_TOL relative (with 6 precomputed embeddings before
    the tokens where ``embeds``), greedy tokens of 4 requests through the
    Scheduler identical, and the forward's launches the ``want_kinds``."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt
    from repro_torch.serve import Request, Scheduler

    scfg = dataclasses.replace(get_config(arch, smoke=True,
                                          attention_mode=mode),
                               compute_dtype="float32")
    if fuse is not None:
        scfg = dataclasses.replace(scfg, rm=dataclasses.replace(
            scfg.rm, fuse_featurize=fuse))
    p_cpu = tt.init_model(scfg, torch.Generator().manual_seed(0))
    p_gpu = tree_to(p_cpu, "cuda")
    rng = np.random.default_rng(27)
    batch = {"tokens": torch.from_numpy(rng.integers(0, scfg.vocab_size,
                                                     size=(2, 24)))}
    if embeds:
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (2, 6, scfg.d_model)).astype(np.float32) * 0.02)
    for fn in counters.values():
        fn.launches = 0
    with torch.inference_mode():
        lg_gpu, _ = tt.forward(p_gpu, scfg, {k: v.cuda()
                                             for k, v in batch.items()})
        lg_cpu, _ = tt.forward(p_cpu, scfg, batch)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    rel = rel_err(torch, lg_gpu, lg_cpu)
    small_prompts = {rid: rng.integers(0, scfg.vocab_size, size=n)
                     for rid, n in enumerate((3, 17, 33, 40))}
    got = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        sched = Scheduler(scfg, params, num_slots=2, max_len=64, device=dev)
        for rid, prompt in small_prompts.items():
            sched.submit(Request(rid, prompt, max_new_tokens=8))
        got[dev] = {rid: s.generated for rid, s in sched.run().items()}
    print(f"[small] {scfg.name} {label} fp32, card vs CPU: logits "
          f"{tuple(lg_gpu.shape)} rel err {rel:.2e} (tol {E2E_TOL:.0e}), "
          f"greedy tokens of {len(small_prompts)} requests identical "
          f"{got['cuda'] == got['cpu']}; forward launches {launches}")
    if not (rel <= E2E_TOL and got["cuda"] == got["cpu"]
            and set(launches) == want_kinds
            and all(len(g) == 8 for g in got["cuda"].values())):
        raise AssertionError(f"{arch} SMOKE {label} card vs CPU failed")


def serve_full_width(torch, np, tag, engine, cfg, prompts, counters):
    """Phase 7's workload (its lengths, ids from ``cfg``'s vocabulary) on
    a full-width engine with every counter at 0: every request finishes
    with valid tokens. Returns (finished, launches, admissions, decode
    steps, the prompts served)."""
    from repro_torch.launch.serve import summarize

    rng = np.random.default_rng(0)
    own = {rid: rng.integers(0, cfg.vocab_size, size=len(p_))
           for rid, p_ in prompts.items()}
    for fn in counters.values():
        fn.launches = 0
    done, admissions, steps, wall = run_workload(torch, engine, own, 0)
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    stats = summarize(done)
    lengths = sorted({engine.executor.bucket_for(len(p_))
                      for p_ in own.values()})
    kind = "buckets" if engine.executor.bucketed else "own lengths"
    print(f"[{tag}] cold run: {stats['requests']} requests, prefills at "
          f"{kind} {lengths}, {stats['tokens']} tokens in {wall:.3f}s "
          f"({stats['tokens'] / wall:.1f} tok/s), TTFT p50 "
          f"{stats['ttft_p50_s'] * 1e3:.1f} ms p99 "
          f"{stats['ttft_p99_s'] * 1e3:.1f} ms; {admissions} admissions, "
          f"{steps} decode steps, launches {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for rid, s_ in done.items():
        if s_.finish_reason not in VALID_REASONS or not s_.generated or \
                not all(0 <= tok < cfg.vocab_size for tok in s_.generated):
            raise AssertionError(f"{tag} request {rid}: "
                                 f"{s_.finish_reason} {s_.generated}")
    if admissions != len(own) or not steps:
        raise AssertionError(f"{tag}: {admissions} admissions, {steps} "
                             "decode steps")
    return done, launches, admissions, steps, own


def ssm_phase(torch, np, kernels, counters, prompts):
    """Phase 27 (see the module docstring): (a) the six new configs' SMOKE
    card vs CPU, (b) B2 and B1 at jamba's width, (c) jamba-v0.1-52b at full
    width (8 of its 32 layers) in rm mode, (d) xlstm-350m at full width and
    depth. Every check is fatal."""
    from repro_torch.configs import get_config
    from repro_torch.core.plan import init_omegas, pack_omegas, plan_columns
    from repro_torch.launch.serve import make_engine
    from repro_torch.models.attention import rm_plan_for

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)

    # a. SMOKE card vs CPU
    for case in SMOKE_CASES:
        smoke_card_vs_cpu(torch, np, counters, *case)

    # b. B2 at jamba's exact-length prefills, B1 at its decode shape
    cfg = dataclasses.replace(get_config(JAMBA, attention_mode="rm"),
                              num_layers=JAMBA_DEPTH).validate()
    dh, heads = cfg.resolved_head_dim, cfg.num_heads
    plan = rm_plan_for(cfg, dh)
    w32 = pack_omegas(plan, init_omegas(plan, gen))
    cd, cs = plan_columns(plan, "cuda")
    print(f"[jamba plan] rm at head width {dh}: packed w "
          f"{tuple(w32.shape)}, F={plan.output_dim}; {heads} heads over "
          f"{cfg.num_kv_heads} kv heads (k and v repeated to {heads})")
    for t in JAMBA_PREFILL_T:
        kernels["B2"].update(prefixed(f"jamba_t{t}", b2_shape_check(
            torch, np, gen, w32, cd, cs, heads, dh, cfg.rm.eps, t, 0,
            "jamba")))
    kernels["B1"].update(prefixed("jamba", b1_shape_check(
        torch, np, gen, w32, cd, cs, 2 * 4 * heads, "jamba")))
    del w32

    # c. jamba-v0.1-52b at full width, one pattern period, rm
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = make_engine(JAMBA, cfg=cfg, num_slots=4, max_len=256, seed=0,
                         device="cuda", param_dtype="bfloat16")
    torch.cuda.synchronize()
    ready_s = time.perf_counter() - t0
    n_params = sum(p_.numel() for p_ in tree_leaves(engine.executor.params))
    p_bytes = sum(p_.numel() * p_.element_size()
                  for p_ in tree_leaves(engine.executor.params))
    state_bytes = sum(t_.numel() * t_.element_size()
                      for t_ in tree_leaves(engine.executor.cache))
    moe, mc = cfg.moe, cfg.mamba
    print(f"[jamba] {cfg.name}: depth cut from 32 to {cfg.num_layers} "
          f"layers (one period: {', '.join(cfg.block_pattern)}), d_model "
          f"{cfg.d_model}, {heads} heads / {cfg.num_kv_heads} kv of {dh}, "
          f"d_ff {cfg.d_ff}, {moe.num_experts} experts top-{moe.top_k}, "
          f"mamba d_state {mc.d_state} expand {mc.expand} d_conv "
          f"{mc.d_conv}, vocab {cfg.vocab_size}, rm attention (F "
          f"{plan.output_dim}); {n_params / 1e9:.2f} B parameters, "
          f"{p_bytes / 2**30:.2f} GiB (bf16; a_log, d_skip and the router "
          f"fp32), ready in {ready_s:.2f}s; decode state "
          f"{state_bytes / 2**20:.2f} MiB (4 lanes: 7 x mamba conv + ssm, "
          f"1 x rm_s / rm_n)")
    done, launches, admissions, steps, own = serve_full_width(
        torch, np, "jamba", engine, cfg, prompts, counters)
    kernels["B2"]["jamba_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if launches != {"B1": steps, "B2": admissions}:
        raise AssertionError(f"jamba launches {launches}: want B2 once a "
                             f"prefill ({admissions}), B1 once a decode "
                             f"step ({steps})")
    kernels["B1"]["jamba_launches"] = launches["B1"]
    kernels["B2"]["jamba_launches"] = launches["B2"]
    shares = where_time_goes(
        torch, "jamba", engine, own, done,
        families={"B1": ("rm_feature_kernel",), "B2": ("chunk_",)},
        prefill_label="prefill T 200")
    kernels["B1"]["jamba_decode_step_device_ms"] = \
        shares["decode step"]["B1"]
    kernels["B2"]["jamba_prefill_200_device_ms"] = \
        shares["prefill T 200"]["B2"]
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # d. xlstm-350m at full width and depth: attention-free, no RM kernel
    xcfg = get_config(XLSTM)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = make_engine(XLSTM, cfg=xcfg, num_slots=4, max_len=256, seed=0,
                         device="cuda")
    torch.cuda.synchronize()
    ready_s = time.perf_counter() - t0
    n_params = sum(p_.numel() for p_ in tree_leaves(engine.executor.params))
    mlstm_bytes = sum(t_.numel() * t_.element_size()
                      for layer in engine.executor.cache["layers"]
                      if "c" in layer and layer["c"].dim() == 4
                      for t_ in layer.values())
    state_bytes = sum(t_.numel() * t_.element_size()
                      for t_ in tree_leaves(engine.executor.cache))
    d_up = int(xcfg.xlstm.proj_factor * xcfg.d_model)
    print(f"[xlstm] {xcfg.name}: {xcfg.num_layers} layers ("
          f"{', '.join(xcfg.block_pattern)} x {xcfg.num_scanned_groups}), "
          f"d_model {xcfg.d_model}, {xcfg.num_heads} heads, mLSTM d_up "
          f"{d_up} (head {d_up // xcfg.num_heads}), tied embeddings, vocab "
          f"{xcfg.vocab_size}; depth not cut; {n_params / 1e9:.3f} B "
          f"parameters (fp32 masters), ready in {ready_s:.2f}s; mLSTM decode "
          f"state {mlstm_bytes / 2**20:.1f} MiB (4 lanes x 18 layers x "
          f"{xcfg.num_heads} heads x {d_up // xcfg.num_heads}^2 fp32 + n, "
          f"m, conv), all decode state {state_bytes / 2**20:.1f} MiB")
    done, launches, _, _, own = serve_full_width(
        torch, np, "xlstm", engine, xcfg, prompts, counters)
    if launches:
        raise AssertionError(f"xlstm launched RM kernels {launches}")
    where_time_goes(torch, "xlstm", engine, own, done,
                    prefill_label="prefill T 200")
    if any(fn.launches for fn in counters.values()):
        raise AssertionError("xlstm's warm run and windows launched an RM "
                             "kernel")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[ssm] phase 27 in {time.perf_counter() - t_phase:.2f}s")


# -- phase 28: meshes (the sharded estimator, data-parallel training) --------
SHARD_GRAM_TOL = 1e-4   # relative: a card Gram of 4 shards against the CPU's
MESH_GRAM_TOL = 1e-5    # x max(1, max |host|): one all_reduce vs a serial sum
DP_STEPS = 3            # qwen3-1.7b steps per Trainer in phase 28 d
GLOO_RANKS = 2          # phase 28 c: processes sharing cuda:0 over gloo
GLOO_ROWS = 4096        # rows of the adult-shaped x phase 28 c featurizes
SPAWN_TIMEOUT = 180     # s: the gloo ranks of phase 28 c


def _gloo_shard_worker(rank, world, store, out_dir):
    """Phase 28 c, one rank: join a gloo group on cuda:0, draw its own
    shard of the adult-shaped map (poly10, d 123, D 4000, seed 0), featurize
    the rows the parent wrote (one B1 launch) and estimate their first
    2048 rows' Gram (one all_reduce); rank 0 writes both back."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.core import PolynomialKernel, make_feature_map
        from repro_torch.distributed import collectives
        from repro_torch.kernels.rm_feature.ops import rm_feature_fused
        from repro_torch.launch.mesh import make_feature_mesh

        out = Path(out_dir)
        mesh = make_feature_mesh(device_type="cuda")
        x = torch.load(out / "x.pt").cuda()
        fm = make_feature_map(PolynomialKernel(10, 1.0), 123, 4000, seed=0,
                              mesh=mesh)
        rm_feature_fused.launches = 0
        z = fm.apply(x)
        torch.cuda.synchronize()
        apply_launches = rm_feature_fused.launches
        calls = collectives.all_reduce.calls
        g = fm.estimate_gram(x[:2048])
        torch.cuda.synchronize()
        report = {"apply_launches": apply_launches,
                  "gram_all_reduces": collectives.all_reduce.calls - calls,
                  "device": str(z.device)}
        if rank == 0:
            torch.save({"z": z.cpu(), "g": g.cpu()}, out / "gloo.pt")
        (out / f"gloo{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world, *args):
    """``fn(rank, world, *args)`` in ``world`` spawned processes, each
    joined within ``SPAWN_TIMEOUT``; a hang or a non-zero exit fails."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, world, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + SPAWN_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.perf_counter()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    if hung or any(p.exitcode for p in procs):
        raise AssertionError(f"spawned ranks: {len(hung)} hung, exit codes "
                             f"{[p.exitcode for p in procs]}")


def meshes_phase(torch, np, kernels, counters):
    """Phase 28 (see the module docstring): (a) the sharded host loop on
    the card, (b) a one-rank NCCL feature mesh, (c) two gloo ranks on
    cuda:0, (d) data-parallel qwen3-1.7b training on a world of one. Every
    check is fatal."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import (
        ExponentialDotProductKernel,
        PolynomialKernel,
        make_feature_map,
    )
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import (
        init_distributed,
        make_feature_mesh,
        make_host_mesh,
        make_mesh,
    )
    from repro_torch.train.steps import TrainHyper
    from repro_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(28)
    poly10 = PolynomialKernel(10, 1.0)

    def launched(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counters.items()
                     if c.launches}

    # a. the sharded host loop: the adult-shaped map as 4 shards
    shards = 4
    sfm = make_feature_map(poly10, 123, 4000, seed=0, num_shards=shards)
    x = unit_rows(torch, (20000, 123), gen) * 0.95
    z, launches = launched(lambda: sfm.apply(x))
    if launches != {"B1": shards} or not torch.isfinite(z).all():
        raise AssertionError(f"28 a: launches {launches}, want B1 x "
                             f"{shards}; finite {torch.isfinite(z).all()}")
    cpu = dataclasses.replace(sfm, params={k: v.cpu()
                                           for k, v in sfm.params.items()})
    z_err = rel_err(torch, z[:2048].cpu(), cpu.apply(x[:2048].cpu()))
    g_card = sfm.estimate_gram(x[:2048])
    g_err = rel_err(torch, g_card.cpu(), cpu.estimate_gram(x[:2048].cpu()))
    ms_s = time_ms(torch, lambda: sfm.apply(x), iters=10)
    dev_s = kernel_device_ms(torch, lambda: sfm.apply(x),
                             "rm_feature_kernel", iters=10)
    fm1 = make_feature_map(poly10, 123, 4000, seed=0)
    ms_1 = time_ms(torch, lambda: fm1.apply(x), iters=10)
    dev_1 = kernel_device_ms(torch, lambda: fm1.apply(x),
                             "rm_feature_kernel", iters=10)
    print(f"[mesh a] adult-shaped poly10 d 123 D 4000 as {shards} shards of "
          f"{sfm.shard_output_dim} columns (host loop) on x[20000,123]: B1 x "
          f"{launches['B1']} an apply; first 2048 rows card vs CPU: features "
          f"{z_err:.3e} (tol {B1_TOL:.0e}), Gram {g_err:.3e} (tol "
          f"{SHARD_GRAM_TOL:.0e}); apply {ms_s:.4f} ms events, B1 device "
          f"{dev_s:.4f} ms (4 launches) against one unsharded D 4000 B1 call "
          f"{ms_1:.4f} ms events, {dev_1:.4f} ms device")
    if not (z_err <= B1_TOL and g_err <= SHARD_GRAM_TOL):
        raise AssertionError(f"28 a: card vs CPU {z_err}, {g_err}")
    kernels["B1"].update(sharded_launches=launches["B1"],
                         sharded_apply_ms=ms_s, sharded_device_ms=dev_s)
    del z, g_card, fm1
    exp1 = ExponentialDotProductKernel(1.0)
    x64 = unit_rows(torch, (64, 128), gen)
    for kid, family in (("B6", "tensor_sketch"), ("B7", "ctr"),
                        ("B8", "structured")):
        ffm = make_feature_map(exp1, 128, 1024, seed=0, num_shards=shards,
                               estimator=family, measure="proportional")
        zf, launches = launched(lambda: ffm.apply(x64))
        cpu_f = dataclasses.replace(ffm, params={
            k: v.cpu() for k, v in ffm.params.items()})
        err = rel_err(torch, zf.cpu(), cpu_f.apply(x64.cpu()))
        print(f"[mesh a] {family} exp D 1024 as {shards} shards on "
              f"x[64,128]: {kid} x {launches.get(kid)}, card vs CPU "
              f"{err:.3e} (tol {B1_TOL:.0e})")
        if launches != {kid: shards} or not err <= B1_TOL:
            raise AssertionError(f"28 a {family}: launches {launches}, "
                                 f"error {err}")
        kernels[kid]["sharded_launches"] = launches[kid]

    # b. a one-rank NCCL feature mesh
    init_distributed(device="cuda")
    try:
        mesh = make_feature_mesh()
        mfm = make_feature_map(poly10, 123, 4000, seed=0, mesh=mesh)
        z_mesh, launches = launched(lambda: mfm.apply(x))
        z_host = mfm.apply(x, sharded=False)
        calls = collectives.all_reduce.calls
        g_mesh = mfm.estimate_gram(x[:2048])
        reduces = collectives.all_reduce.calls - calls
        g_host = mfm.estimate_gram(x[:2048], sharded=False)
        g_gap = rel_err(torch, g_mesh, g_host)
        same = torch.equal(z_mesh, z_host)
        print(f"[mesh b] NCCL world of {dist.get_world_size()}, mesh "
              f"{mesh}: apply B1 x {launches.get('B1')}, bitwise the host "
              f"loop {same}; Gram {reduces} all_reduce, {g_gap:.3e} from the "
              f"host loop (tol {MESH_GRAM_TOL:.0e})")
        if not (same and reduces == 1 and launches == {"B1": 1}
                and g_gap <= MESH_GRAM_TOL):
            raise AssertionError("28 b: the NCCL feature mesh failed")
        del z_mesh, z_host, g_mesh, g_host, mfm

        # c. two gloo processes on cuda:0, one shard each
        with tempfile.TemporaryDirectory() as tmp:
            torch.save(x[:GLOO_ROWS].cpu(), Path(tmp) / "x.pt")
            t0 = time.perf_counter()
            spawn_ranks(_gloo_shard_worker, GLOO_RANKS,
                        str(Path(tmp) / "store"), tmp)
            spawn_s = time.perf_counter() - t0
            reports = [json.loads((Path(tmp) / f"gloo{r}.json").read_text())
                       for r in range(GLOO_RANKS)]
            got = torch.load(Path(tmp) / "gloo.pt")
        host = make_feature_map(poly10, 123, 4000, seed=0,
                                num_shards=GLOO_RANKS)
        same = torch.equal(got["z"], host.apply(x[:GLOO_ROWS]).cpu())
        g_gap = rel_err(torch, got["g"], host.estimate_gram(x[:2048]).cpu())
        print(f"[mesh c] {GLOO_RANKS} gloo processes on cuda:0 ({spawn_s:.1f}s"
              f" with their start-up): per rank {reports}; apply on "
              f"x[{GLOO_ROWS},123] bitwise the host loop of {GLOO_RANKS} "
              f"shards {same}; Gram {g_gap:.3e} from it (tol "
              f"{MESH_GRAM_TOL:.0e}); no host copy (gloo takes CUDA tensors)")
        if not (same and g_gap <= MESH_GRAM_TOL and all(
                r["apply_launches"] == 1 and r["gram_all_reduces"] == 1
                for r in reports)):
            raise AssertionError("28 c: the gloo ranks failed")
        del host, got

        # d. data-parallel qwen3-1.7b training on a world of one
        cfg = get_config("qwen3-1.7b", attention_mode="rm")
        data = SyntheticLMDataset(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                  seed=0, device="cuda")
        runs = {}
        for label, mesh_fn, compression in (
                ("none", None, "none"),
                ("host", make_host_mesh, "none"),
                ("int8_pod", lambda: make_mesh((1, 1, 1),
                                               ("pod", "data", "model")),
                 "int8_pod")):
            hyper = TrainHyper(peak_lr=1e-3, warmup_steps=2,
                               total_steps=DP_STEPS,
                               grad_compression=compression)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() / 2**30
            trainer = Trainer(cfg, hyper, data, seed=0, log_every=1,
                              mesh=mesh_fn() if mesh_fn else None,
                              checkpoint_every=10 ** 9, device="cuda")
            t0 = time.perf_counter()
            state, launches = launched(lambda: trainer.train(DP_STEPS))
            wall = time.perf_counter() - t0
            runs[label] = {
                "losses": [row["loss"] for row in trainer.metrics_log],
                "grad_norms": [row["grad_norm"]
                               for row in trainer.metrics_log],
                "step_ms": [row["sec_per_step"] * 1e3
                            for row in trainer.metrics_log],
                "launches": launches, "wall": wall,
                "peak": torch.cuda.max_memory_allocated() / 2**30,
                "base": base,
                "residual_max": (max(float(t.abs().max()) for t in
                                     tree_leaves(state["residuals"]))
                                 if "residuals" in state else None)}
            del state, trainer
        want = {"B2": train_launches(cfg) * DP_STEPS}
        for label, r in runs.items():
            print(f"[mesh d] qwen3-1.7b rm {TRAIN_BATCH} x {TRAIN_SEQ} tokens,"
                  f" {DP_STEPS} steps, mesh {label}: losses "
                  + " ".join(f"{v:.6f}" for v in r["losses"])
                  + "; step walls " + " / ".join(f"{v:.1f}"
                                                 for v in r["step_ms"])
                  + f" ms; launches {r['launches']}; {r['wall']:.2f}s; peak "
                  f"{r['peak']:.2f} GiB with {r['base']:.2f} GiB held before "
                  f"(phase 24 c, {TRAIN_DEPTH} layers: "
                  f"{kernels['B2']['train_peak_gib']:.2f} GiB)"
                  + (f"; residual max {r['residual_max']:.3e}"
                     if r["residual_max"] is not None else ""))
            if r["launches"] != want or not all(
                    math.isfinite(v) for v in r["losses"]):
                raise AssertionError(f"28 d {label}: launches "
                                     f"{r['launches']} (want {want})")
        if runs["host"]["losses"] != runs["none"]["losses"]:
            raise AssertionError("28 d: the one-rank mesh's losses are not "
                                 "bitwise mesh=None's")
        kernels["B2"]["dp_train_launches"] = sum(
            r["launches"]["B2"] for r in runs.values())
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[mesh] phase 28 in {time.perf_counter() - t_phase:.2f}s")


# -- phase 29: tensor parallelism over "model", data-parallel serving --------
TP_RANKS = 2            # gloo processes sharing cuda:0 in phase 29
TP_TRAIN_TOL = 2e-2     # relative: bf16 losses, and the first grad_norm, 2
# ranks vs one (the later bf16 grad norms are printed, not held: once bf16
# rounding has moved the weights apart, a head whose rm denominator nears
# its clamp moves the norm by 10% either way; ROADMAP.md queue C)
TP_FP32_TOL = 1e-3      # relative: fp32 losses and every grad_norm, 2 vs 1
TP_LEAVES = 4           # gradient leaves printed where two runs part most
ENC_TP_CLIPS = 2        # hubert-xlarge clips of ENC_FRAMES in phase 29 d


def _tp_join(rank, world, store):
    """Join the phase's gloo group of ``world`` ranks on cuda:0."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)


def _tp_counters():
    from repro_torch.kernels.rm_attention.ops import (
        rm_fused_apply,
        rm_fused_causal,
        rm_fused_state,
    )
    from repro_torch.kernels.rm_feature.ops import rm_feature_fused

    return {"B1": rm_feature_fused, "B2": rm_fused_causal,
            "B3": rm_fused_state, "B4": rm_fused_apply}


@contextlib.contextmanager
def clamp_probe(torch, layer):
    """Inside: the model's fused causal rm op records, at its ``layer``-th
    call (the layer's attention in a forward), the smallest |den| of its
    heads (the signed denominator ``z(q_t) . sum_{s <= t} z(k_s)`` from
    the plain featurize, fp32) and how many positions sit within 10 eps of
    the clamp. Yields the record."""
    from repro_torch.kernels.rm_attention.ref import featurize_ref4
    from repro_torch.models import attention as am

    orig = am.rm_attention_fused_causal
    seen = {"calls": 0}

    def probed(q, k, v, w, cd, cs, **kw):
        if seen["calls"] == layer:
            with torch.no_grad():
                zq = featurize_ref4(q.detach().float(), w.float(), cd, cs)
                zk = featurize_ref4(k.detach().float(), w.float(), cd, cs)
                den = (zq * zk.cumsum(2)).sum(-1).abs()
                eps = kw["eps"]
                seen.update(min_den=float(den.min()), eps=eps,
                            near=int((den < 10 * eps).sum()),
                            positions=den.numel())
                del zq, zk, den
        seen["calls"] += 1
        return orig(q, k, v, w, cd, cs, **kw)

    am.rm_attention_fused_causal = probed
    try:
        yield seen
    finally:
        am.rm_attention_fused_causal = orig


CLAMP_LAYER = 15         # the layer whose bf16 gradient parts most (29 a)


def tp_train_run(torch, mesh, dtype, *, leaves=True, rules=None,
                 remat=True):
    """Phase 29 a and 30 c: qwen3-1.7b rm (phase 24 c's 4 x 256 tokens,
    ``dtype`` compute) DP_STEPS steps through the Trainer on ``mesh``
    (None: one device), under the sharding ``rules`` where given (e.g.
    ``{"act_seq": None}``). Per step this rank's B2 launches and its
    all-reduces over "model"; the bytes of its train state; with
    ``leaves``, before the last step, ``[local shape, squared norm]`` of
    every gradient leaf at the state that step starts from
    (``train.steps.loss_grads`` on its batch, beside the step) and layer
    CLAMP_LAYER's smallest |rm denominator| there (``clamp_probe``);
    ``remat``: the config's activation checkpointing (phase 31 a runs it
    off too); ``base_gib``: the device bytes held before the run;
    ``state_bytes``: the whole train state's (its two steps too)."""
    from repro_torch.common.tree import flatten_dict
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.distributed import collectives
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import logical_rules_context
    from repro_torch.train.steps import TrainHyper, loss_grads
    from repro_torch.train.trainer import Trainer

    counters = _tp_counters()
    cfg = dataclasses.replace(get_config("qwen3-1.7b", attention_mode="rm"),
                              compute_dtype=dtype, remat=remat)
    lcfg = cfg if mesh is None else tp.local_config(cfg, TP_RANKS)
    data = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH, seed=0,
                              device="cuda")
    hyper = TrainHyper(peak_lr=1e-3, warmup_steps=2, total_steps=DP_STEPS)
    group = None if mesh is None else mesh.get_group("model")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with (contextlib.nullcontext() if rules is None
          else logical_rules_context(mesh, rules)):
        trainer = Trainer(cfg, hyper, data, seed=0, log_every=1, mesh=mesh,
                          checkpoint_every=10 ** 9, device="cuda")
        state = trainer.init_or_restore()
        b2, reduces, grad_leaves, den = [], [], {}, {}
        for step in range(1, DP_STEPS + 1):
            if step == DP_STEPS and leaves:
                batch = {k: v.to("cuda")
                         for k, v in data.batch_at(step - 1).items()}
                with (contextlib.nullcontext() if mesh is None
                      else tp.local_view(mesh)), \
                        clamp_probe(torch, CLAMP_LAYER) as den:
                    grads, _ = loss_grads(lcfg, state["params"], batch)
                grad_leaves = {k: [list(g.shape),
                                   float(torch.sum(g.float() ** 2))]
                               for k, g in flatten_dict(grads).items()}
                del grads, batch
            for c in counters.values():
                c.launches = 0
            calls = collectives.all_reduce.by_group.get(group, 0)
            state = trainer.train(step, state)
            torch.cuda.synchronize()
            b2.append(counters["B2"].launches)
            reduces.append(collectives.all_reduce.by_group.get(group, 0)
                           - calls)
    state_bytes = sum(t_.numel() * t_.element_size() for t_ in tree_leaves(
        [state["params"], state["opt"]["mu"], state["opt"]["nu"]]))
    return {"losses": [r["loss"] for r in trainer.metrics_log],
            "grad_norms": [r["grad_norm"] for r in trainer.metrics_log],
            "step_ms": [r["sec_per_step"] * 1e3 for r in trainer.metrics_log],
            "b2": b2, "model_all_reduces": reduces, "leaves": grad_leaves,
            "den": den, "state_gib": state_bytes / 2**30,
            "local_heads": lcfg.num_heads, "base_gib": base / 2**30,
            "state_bytes": sum(t_.numel() * t_.element_size()
                               for t_ in tree_leaves(state)),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "device": str(next(iter(state["params"]["embed"].values()))
                          .device)}


def _tp_train_worker(rank, world, store, out_dir):
    """Phase 29 a, one rank: ``tp_train_run`` on a (data 1, model 2) mesh
    in bf16 and then in fp32 compute."""
    import torch
    import torch.distributed as dist

    _tp_join(rank, world, store)
    try:
        from repro_torch.launch.mesh import make_mesh

        mesh = make_mesh((1, world), ("data", "model"), device_type="cuda")
        for dtype in ("bfloat16", "float32"):
            report = tp_train_run(torch, mesh, dtype)
            (Path(out_dir) / f"train{rank}_{dtype}.json").write_text(
                json.dumps(report))
    finally:
        dist.destroy_process_group()


def leaf_gaps(one, ranks):
    """``[(relative gap, leaf, one device's squared norm, the mesh's)]``,
    largest gap first: a leaf cut over "model" (its local shape not one
    device's) sums the ranks' squares, a replicated one is rank 0's."""
    rows = []
    for k, (shape, v) in one.items():
        s0, v0 = ranks[0][k]
        tp_v = v0 + (ranks[1][k][1] if s0 != shape else 0.0)
        rows.append((abs(tp_v - v) / max(v, 1e-30), k, v, tp_v))
    return sorted(rows, reverse=True)


def serve_rows(torch, engine, prompts):
    """``run_workload`` (phase 7's requests, ids 0..) with the logits row
    behind every sampled token kept on the host -> (its four results,
    ``{(request, token index): row [V] fp32}``)."""
    ex = engine.executor
    admit, decode = ex.admit, ex.decode
    rows = {}

    def admit_rows(slot, prompt):
        row, tb = admit(slot, prompt)
        rid = next(r for r, p_ in prompts.items() if p_ is prompt)
        rows[(rid, 0)] = row[0].float().cpu()
        return row, tb

    def decode_rows(tokens, positions):
        logits = decode(tokens, positions)
        for i, st in enumerate(engine.slots):
            if st is not None:
                rows[(st.request.request_id, len(st.generated))] = \
                    logits[i, 0].float().cpu()
        return logits

    ex.admit, ex.decode = admit_rows, decode_rows
    try:
        return run_workload(torch, engine, prompts, 0), rows
    finally:
        ex.admit, ex.decode = admit, decode


def parting_points(tokens, want):
    """``{request: first token index where tokens[request] parts from
    want[request]}``, for the requests that part."""
    out = {}
    for rid, w in want.items():
        j = next((i for i, (a, b) in enumerate(zip(tokens[rid], w))
                  if a != b), None)
        if j is not None:
            out[rid] = j
    return out


def _tp_serve_worker(rank, world, store, out_dir, shape):
    """Phase 29 b, one rank: phase 7's workload through the Scheduler on a
    ``shape`` mesh, the weights whole over "data" (``rules={"fsdp":
    None}``); the rank's tokens, B1 / B2 launches and peak memory.
    Where a request parts from phase 7's tokens, rank 0 keeps the logits
    row its token was sampled from there."""
    import torch
    import torch.distributed as dist

    _tp_join(rank, world, store)
    try:
        from repro_torch.distributed.sharding import logical_rules_context
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.serve import make_engine

        out = Path(out_dir)
        counters = _tp_counters()
        given = torch.load(out / "serve_in.pt", weights_only=False)
        mesh = make_mesh(shape, ("data", "model"), device_type="cuda")
        torch.cuda.reset_peak_memory_stats()
        # the weights whole over "data": phase 31 c
        # holds the cut (gathered through gloo, 2.5 s a decode step) alone
        with logical_rules_context(mesh, {"fsdp": None}):
            engine = make_engine("qwen3-1.7b", smoke=False,
                                 attention_mode="rm", num_slots=4,
                                 max_len=256, seed=0, device="cuda",
                                 mesh=mesh)
        for c in counters.values():
            c.launches = 0
        (done, admissions, steps, wall), rows = serve_rows(
            torch, engine, given["prompts"])
        tokens = {rid: s_.generated for rid, s_ in done.items()}
        launches = {k: c.launches for k, c in counters.items()
                    if c.launches}
        ex = engine.executor
        report = {"tokens": tokens, "launches": launches,
                  "admissions": admissions, "steps": steps, "wall": wall,
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "local_slots": ex.local_slots,
                  "local_heads": ex.model_cfg.num_heads}
        (out / f"serve{rank}.json").write_text(json.dumps(report))
        if rank == 0:
            parts = parting_points(tokens, given["tokens"])
            torch.save({rid: (j, rows[(rid, j)]) for rid, j in parts.items()},
                       out / "parting.pt")
    finally:
        dist.destroy_process_group()


def tp_encode_cases():
    """Phase 29 c-d's ``(tag, config)``: deepseek-v2-lite-16b rm with bf16
    weights; the same cut to 4 layers (its dense first layer and 3 MoE
    layers) in fp32; hubert-xlarge rm in fp32. The fp32 runs are held to
    E2E_TOL at every logit: they show whether the bf16 run's gap is the
    rounding's, amplified over the depth and through the router's
    discontinuous choices, or the MoE's tensor-parallel path's."""
    from repro_torch.configs import get_config

    ds = get_config(DEEPSEEK, attention_mode="rm")
    fp32 = {"param_dtype": "float32", "compute_dtype": "float32"}
    return (("ds", dataclasses.replace(ds, param_dtype="bfloat16")),
            ("ds_moe", dataclasses.replace(ds, num_layers=4, **fp32)),
            ("hubert", dataclasses.replace(
                get_config("hubert-xlarge", attention_mode="rm"), **fp32)))


def tp_encode(torch, cfg, given, mesh):
    """One case of phase 29 c-d on ``mesh`` (None: one device) ->
    ``(logits, the first MoE layer's y or None, seconds to draw the
    weights, seconds of the prefill or encode)``. A decoder is drawn by ``launch.serve.make_engine`` (on a
    mesh each rank draws its shards, block by block) and prefills the 4 x
    256 tokens with the engine's compute weights; the encoder's weights
    come from ``tensor_parallel.init_local_params`` (one device:
    ``train.steps.init_params``) and encode the clips. The MoE layer runs
    ``apply_moe(mesh=)`` on the saved input."""
    import contextlib

    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.serve import make_engine
    from repro_torch.models.moe import apply_moe
    from repro_torch.models.transformer import forward, prefill
    from repro_torch.train.steps import init_params

    t0 = time.perf_counter()
    if cfg.causal:
        ex = make_engine(DEEPSEEK, cfg=cfg, num_slots=1, max_len=256, seed=0,
                         device="cuda", mesh=mesh).executor
        params, compute, lcfg = ex.params, ex.compute_params, ex.model_cfg
    elif mesh is None:
        params = compute = init_params(cfg, 0, "cuda")
        lcfg = cfg
    else:
        params, _ = tp.init_local_params(cfg, 0, mesh, "cuda")
        compute, lcfg = params, tp.local_config(cfg, TP_RANKS)
    torch.cuda.synchronize()
    ready = time.perf_counter() - t0
    view = (contextlib.nullcontext() if mesh is None
            else tp.local_view(mesh))
    y = None
    t0 = time.perf_counter()
    with torch.inference_mode(), view:
        if cfg.causal:
            logits, _ = prefill(compute, lcfg, {"tokens": given["ds"].cuda()},
                                256)
        else:
            logits, _ = forward(compute, lcfg,
                                {"embeds": given["hubert"].cuda()})
        logits = tp.gather_vocab(logits, lcfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if cfg.moe is not None and cfg.param_dtype == "bfloat16":
        with torch.inference_mode():
            y, _ = apply_moe(params["layers"][1]["moe"], cfg,
                             given["moe_x"].cuda(), mesh=mesh)
    return logits, y, ready, wall


def _tp_encode_worker(rank, world, store, out_dir):
    """Phase 29 c and d, one rank: each of ``tp_encode_cases`` through
    ``tp_encode`` on a (1, 2) mesh. Rank 0 holds them against the one-rank
    results the parent saved."""
    import torch
    import torch.distributed as dist

    _tp_join(rank, world, store)
    try:
        from repro_torch.distributed import tensor_parallel as tp
        from repro_torch.launch.mesh import make_mesh

        out = Path(out_dir)
        counters = _tp_counters()
        given = torch.load(out / "encode_in.pt")
        mesh = make_mesh((1, world), ("data", "model"), device_type="cuda")
        report = {}
        for tag, cfg in tp_encode_cases():
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                c.launches = 0
            logits, y, ready, wall = tp_encode(torch, cfg, given, mesh)
            report[tag] = {
                "launches": {k: c.launches for k, c in counters.items()
                             if c.launches},
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "ready_s": ready, "wall_s": wall,
                "local_heads": tp.local_config(cfg, world).num_heads,
                "finite": bool(torch.isfinite(logits).all())}
            if rank == 0:
                want = torch.load(out / f"{tag}_logits.pt").cuda()
                report[tag]["rel"] = rel_err(torch, logits, want)
                # per position: max |gap| over the vocabulary relative to
                # max(1, max |one rank's logit|) there
                pos = ((logits - want).abs().amax(-1)
                       / want.abs().amax(-1).clamp_min(1.0)).flatten()
                report[tag]["pos_quantiles"] = torch.quantile(
                    pos.float().cpu(), torch.tensor([0.5, 0.9, 0.99])
                ).tolist()
                tol = BF16_LOGITS_TOL if tag == "ds" else E2E_TOL
                report[tag]["pos_within"] = float(
                    (pos <= tol).float().mean())
                report[tag]["argmax_agree"] = float(
                    (logits.argmax(-1) == want.argmax(-1)).float().mean())
                if y is not None:
                    report[tag]["moe_rel"] = rel_err(
                        torch, y.float(), torch.load(out / f"{tag}_moe_y.pt"))
                del want
            del logits, y
        (out / f"encode{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def tensor_parallel_phase(torch, np, kernels, prompts, rm_tokens):
    """Phase 29 (see the module docstring): 2 gloo ranks on cuda:0 train
    qwen3-1.7b on (data 1, model 2), serve phase 7's workload on (2, 1)
    and (1, 2), prefill deepseek-v2-lite-16b and encode hubert-xlarge on
    (1, 2). Every check is fatal."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_engine

    t_phase = time.perf_counter()
    cfg = get_config("qwen3-1.7b", attention_mode="rm")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)

        # a. training on (data 1, model 2) in bf16 and in fp32, each against
        # one device's run (made first, freed before the ranks start)
        dtypes = ("bfloat16", "float32")
        one = {dtype: tp_train_run(torch, None, dtype) for dtype in dtypes}
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        spawn_ranks(_tp_train_worker, TP_RANKS, str(out / "s_train"), tmp)
        spawn_s = time.perf_counter() - t0
        want_b2 = [train_launches(cfg)] * DP_STEPS
        ok = True
        tp_runs = {}
        for dtype in dtypes:
            reps = [json.loads((out / f"train{r}_{dtype}.json").read_text())
                    for r in range(TP_RANKS)]
            ref = one[dtype]
            gaps = [abs(a - b) / abs(b) for a, b in zip(reps[0]["losses"],
                                                        ref["losses"])]
            ngaps = [abs(a - b) / abs(b) for a, b in zip(
                reps[0]["grad_norms"], ref["grad_norms"])]
            bf16 = dtype == "bfloat16"
            tol = TP_TRAIN_TOL if bf16 else TP_FP32_TOL
            print(f"[tp a] qwen3-1.7b rm {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
                  f"{dtype} compute, {DP_STEPS} steps on (data 1, model "
                  f"{TP_RANKS}), {TP_RANKS} gloo processes on cuda:0 "
                  f"({spawn_s:.1f}s for both dtypes with their start-up): "
                  "losses " + " ".join(f"{v:.6f}" for v in reps[0]["losses"])
                  + " against one device's "
                  + " ".join(f"{v:.6f}" for v in ref["losses"])
                  + "; gaps " + " ".join(f"{v:.2e}" for v in gaps)
                  + "; grad_norm " + " ".join(f"{v:.5f}"
                                              for v in reps[0]["grad_norms"])
                  + " against " + " ".join(f"{v:.5f}"
                                           for v in ref["grad_norms"])
                  + "; gaps " + " ".join(f"{v:.2e}" for v in ngaps)
                  + (f" (budget {tol:.0e} on the losses and "
                     + ("the first grad_norm, where both runs hold the same "
                        "weights; the later ones parted by ROADMAP.md queue "
                        "C's bf16 clamp fault)" if bf16
                        else "every grad_norm)")))
            rows = leaf_gaps(ref["leaves"],
                             [r_["leaves"] for r_ in reps])
            big = sorted(((v[1], k) for k, v in ref["leaves"].items()),
                         reverse=True)[:TP_LEAVES]
            print(f"[tp a] {dtype}, the gradient at the state step "
                  f"{DP_STEPS} starts from (loss_grads beside the step): "
                  f"squared norm {sum(v[1] for v in ref['leaves'].values()):.4f}"
                  " on one device; the leaves that part most: "
                  + "; ".join(f"{k} {v:.6g} on one device, {tp_v:.6g} on the"
                              f" mesh ({gap:.2e})"
                              for gap, k, v, tp_v in rows[:TP_LEAVES])
                  + "; the largest on one device: "
                  + ", ".join(f"{k} {v:.4f}" for v, k in big))
            dens = [ref["den"]] + [r_["den"] for r_ in reps]
            print(f"[tp a] {dtype}, layer {CLAMP_LAYER}'s rm attention at "
                  f"that state (clamp_probe, fp32 from the layer's "
                  f"{dtype} q and k): smallest |den| "
                  + ", ".join(f"{lab} {d_['min_den']:.3e} ({d_['near']} of "
                              f"{d_['positions']} head positions within 10 "
                              "eps)" for lab, d_ in zip(
                                  ["one device"] + [f"rank {r}" for r in
                                                    range(TP_RANKS)], dens))
                  + f"; eps {ref['den']['eps']:.0e}")
            kernels["B2"][f"clamp_min_den_{dtype}"] = min(
                d_["min_den"] for d_ in dens)
            for r, rep in enumerate(reps):
                print(f"[tp a] {dtype} rank {r}: {rep['local_heads']} heads "
                      f"(BH {TRAIN_BATCH * rep['local_heads']}), B2 a step "
                      f"{rep['b2']}, all-reduces over 'model' a step "
                      f"{rep['model_all_reduces']}, step walls "
                      + " / ".join(f"{v:.1f}" for v in rep["step_ms"])
                      + f" ms (warm {rep['step_ms'][-1]:.1f} ms; one device "
                      f"{ref['step_ms'][-1]:.1f} ms), peak "
                      f"{rep['peak_gib']:.2f} GiB (one device "
                      f"{ref['peak_gib']:.2f}; phase 24 c, {TRAIN_DEPTH} "
                      f"layers: {kernels['B2']['train_peak_gib']:.2f} GiB),"
                      f" on "
                      f"{rep['device']}")
            held = gaps + (ngaps[:1] if bf16 else ngaps)
            ok = ok and (reps[0]["losses"] == reps[1]["losses"]
                         and reps[0]["grad_norms"] == reps[1]["grad_norms"]
                         and max(held) <= tol and ref["b2"] == want_b2
                         and all(r_["b2"] == want_b2 for r_ in reps)
                         and all(r_["device"] == "cuda:0" for r_ in reps))
            if bf16:
                tp_runs["bf16_mesh_losses"] = reps[0]["losses"]
                kernels["B2"]["tp_train_launches_per_rank_step"] = \
                    reps[0]["b2"][0]
                kernels["B2"]["tp_train_peak_gib_per_rank"] = max(
                    r_["peak_gib"] for r_ in reps)
        tp_runs["one_fp32"] = one["float32"]
        del one
        if not ok:
            raise AssertionError("29 a: tensor-parallel training failed")

        # b. rm serving on (2, 1) and (1, 2)
        torch.save({"prompts": prompts, "tokens": rm_tokens},
                   out / "serve_in.pt")
        for shape in ((TP_RANKS, 1), (1, TP_RANKS)):
            t0 = time.perf_counter()
            spawn_ranks(_tp_serve_worker, TP_RANKS, str(out / f"s_{shape}"),
                        tmp, shape)
            spawn_s = time.perf_counter() - t0
            reps = [json.loads((out / f"serve{r}.json").read_text())
                    for r in range(TP_RANKS)]
            tokens = {int(k): v for k, v in reps[0]["tokens"].items()}
            same = tokens == rm_tokens
            print(f"[tp b] qwen3-1.7b rm, phase 7's workload on (data "
                  f"{shape[0]}, model {shape[1]}) ({spawn_s:.1f}s with the "
                  f"start-up): tokens equal phase 7's (mesh=None, 4 lanes) "
                  f"{same}; ranks agree {reps[0]['tokens'] == reps[1]['tokens']}")
            for r, rep in enumerate(reps):
                print(f"[tp b] rank {r}: {rep['local_slots']} slots, "
                      f"{rep['local_heads']} heads, launches "
                      f"{rep['launches']} over {rep['admissions']} admissions"
                      f" and {rep['steps']} decode steps, {rep['wall']:.3f}s,"
                      f" peak {rep['peak_gib']:.2f} GiB")
            if reps[0]["tokens"] != reps[1]["tokens"]:
                raise AssertionError(f"29 b {shape}: the ranks disagree")
            if shape[1] == 1:
                # each data rank decodes its own lanes: one device serving
                # with that many lanes is the bitwise reference (bf16 decode
                # rows depend on the batch's shape)
                lanes = reps[0]["local_slots"]
                eng = make_engine("qwen3-1.7b", smoke=False,
                                  attention_mode="rm", num_slots=lanes,
                                  max_len=256, seed=0, device="cuda")
                done, *_ = run_workload(torch, eng, prompts, 0)
                want = {r: s_.generated for r, s_ in done.items()}
                del eng
                gc.collect()
                torch.cuda.empty_cache()
                print(f"[tp b] one device serving with {lanes} lanes: tokens"
                      f" equal the data-parallel run's {tokens == want}; "
                      f"they part from phase 7's (4 lanes) at "
                      f"{parting_points(want, rm_tokens)}, the run's at "
                      f"{parting_points(tokens, rm_tokens)}")
                if tokens != want:
                    raise AssertionError("29 b: data-parallel tokens differ "
                                         f"from one device's at {lanes} "
                                         "lanes")
            parting = torch.load(out / "parting.pt")
            if parting and shape[1] > 1:
                # one device's rows at the same tokens: phase 7's serve
                # again, each row kept
                eng = make_engine("qwen3-1.7b", smoke=False,
                                  attention_mode="rm", num_slots=4,
                                  max_len=256, seed=0, device="cuda")
                (done, *_), one_rows = serve_rows(torch, eng, prompts)
                del eng
                gc.collect()
                torch.cuda.empty_cache()
                if {r: s_.generated for r, s_ in done.items()} != rm_tokens:
                    raise AssertionError("29 b: phase 7's serve did not "
                                         "repeat its tokens")
                for rid, (j, row) in sorted(parting.items()):
                    one_row = one_rows[(rid, j)]
                    gap = rel_err(torch, row, one_row)
                    noise = float((row - one_row).abs().max())
                    tok, want_tok = tokens[rid][j], rm_tokens[rid][j]
                    deficit = float(one_row.max() - one_row[tok])
                    print(f"[tp b] request {rid} parts at token {j} "
                          f"({'prefill' if j == 0 else 'decode'}): {tok} "
                          f"against {want_tok}; the rows it was sampled from"
                          f" are {gap:.3e} apart relative (bf16 budget "
                          f"{BF16_LOGITS_TOL:.0e}), {noise:.4f} at most; in "
                          f"one device's row {tok} trails {want_tok} by "
                          f"{deficit:.4f}")
                    if not (gap <= BF16_LOGITS_TOL and deficit <= 2 * noise):
                        raise AssertionError(f"29 b {shape}: request {rid} "
                                             "parts beyond the bf16 noise")
            key = "dp" if shape[1] == 1 else "tp"
            for kid in ("B1", "B2"):
                kernels[kid][f"{key}_serve_launches_per_rank"] = \
                    reps[0]["launches"].get(kid, 0)

        # c, d. deepseek's prefill (and its MoE layer, and a 4-layer fp32
        # cut) and hubert's encode on (1, 2), against one rank's run (kept
        # on the host, freed before the ranks start)
        cases = tp_encode_cases()
        gen = torch.Generator(device="cpu")
        gen.manual_seed(29)
        ds, hb = cases[0][1], cases[2][1]
        given = {"ds": torch.randint(0, ds.vocab_size, (TRAIN_BATCH, 256),
                                     generator=gen),
                 "hubert": torch.randn((ENC_TP_CLIPS, ENC_FRAMES,
                                        hb.d_model), generator=gen),
                 "moe_x": torch.randn((TRAIN_BATCH, 256, ds.d_model),
                                      generator=gen).to(torch.bfloat16)}
        torch.save(given, out / "encode_in.pt")
        one = {}
        for tag, c_ in cases:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            logits, y, _, _ = tp_encode(torch, c_, given, None)
            if y is not None:
                torch.save(y.float().cpu(), out / f"{tag}_moe_y.pt")
            torch.save(logits.cpu(), out / f"{tag}_logits.pt")
            one[tag] = torch.cuda.max_memory_allocated() / 2**30
            del logits, y
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        spawn_ranks(_tp_encode_worker, TP_RANKS, str(out / "s_enc"), tmp)
        spawn_s = time.perf_counter() - t0
        reps = [json.loads((out / f"encode{r}.json").read_text())
                for r in range(TP_RANKS)]
    labels = {"ds": f"deepseek-v2-lite-16b rm bf16 weights, prefill "
                    f"{TRAIN_BATCH} x 256",
              "ds_moe": "the same cut to 4 layers (its dense first layer, "
                        "3 MoE layers), fp32",
              "hubert": f"hubert-xlarge rm fp32, encode {ENC_TP_CLIPS} x "
                        f"{ENC_FRAMES} frames"}
    for tag, c_ in cases:
        want = ({"B3": c_.num_layers, "B4": c_.num_layers} if not c_.causal
                else {"B2": c_.num_layers})
        r0 = reps[0][tag]
        q50, q90, q99 = r0["pos_quantiles"]
        tol = BF16_LOGITS_TOL if tag == "ds" else E2E_TOL
        print(f"[tp c] {labels[tag]} on (data 1, model {TP_RANKS}) "
              f"({spawn_s:.1f}s for the three with the start-up): logits "
              f"{r0['rel']:.3e} from one rank's at most; by position "
              f"{q50:.2e} / {q90:.2e} / {q99:.2e} (median / 90% / 99%), "
              f"{100 * r0['pos_within']:.2f}% of positions within "
              f"{tol:.0e}, greedy tokens agree at "
              f"{100 * r0['argmax_agree']:.2f}%"
              + (f"; its first MoE layer on one input through "
                 f"apply_moe(mesh=) {r0['moe_rel']:.3e} from one rank's"
                 if tag == "ds" else "")
              + f"; one rank's peak {one[tag]:.2f} GiB; per rank: "
              + "; ".join(f"rank {r} {rep[tag]['local_heads']} heads, "
                          f"launches {rep[tag]['launches']}, weights drawn "
                          f"and cut in {rep[tag]['ready_s']:.2f}s, call "
                          f"{rep[tag]['wall_s'] * 1e3:.1f} ms, peak "
                          f"{rep[tag]['peak_gib']:.2f} GiB"
                          for r, rep in enumerate(reps)))
        # the MoE's routing (top-k, then each expert's capacity in token
        # order) is discontinuous: a bf16 difference that flips one choice
        # moves that token, every later token's drops in that expert and,
        # through causal attention, every later position. So the full
        # deepseek prefill is printed; its MoE layer on one input is held
        # to the bf16 budget, and the fp32 runs at every logit to E2E_TOL:
        # the 4-layer cut runs the MoE's tensor-parallel path through 3
        # layers, where a fault that builds up over the layers would show
        held = (r0["moe_rel"] <= BF16_LOGITS_TOL if tag == "ds"
                else r0["rel"] <= E2E_TOL)
        if not (held and all(rep[tag]["finite"]
                             and rep[tag]["launches"] == want
                             for rep in reps)):
            raise AssertionError(f"29 c {tag}: failed")
        for kid, n in want.items():
            kernels[kid][f"tp_{tag}_launches_per_rank"] = n
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[tp] phase 29 in {time.perf_counter() - t_phase:.2f}s")
    return tp_runs


# -- phase 30: SSM tensor parallelism, FSDP over "data", "act_seq" ----------
JAMBA_TP_PROMPT_T = 40     # jamba's prefill on the mesh: "act_seq" divides it
XLSTM_TRAIN_SEQ = 128      # xlstm-350m training tokens a row (4 rows)
SSM_NEW_TOKENS = 8         # greedy tokens a request in phase 30 a-b
XLSTM_TP_DEPTH = 8         # of xlstm-350m's 24 layers in phase 30 b: two
#                            periods of its (mLSTM x 3, sLSTM) pattern


def ssm_tp_configs():
    """Phase 30's configs: jamba-v0.1-52b rm cut to one pattern period in
    fp32 and in bf16 weights (phase 27 c's), xlstm-350m cut to
    XLSTM_TP_DEPTH layers in fp32."""
    from repro_torch.configs import get_config

    jamba = dataclasses.replace(get_config(JAMBA, attention_mode="rm"),
                                num_layers=JAMBA_DEPTH).validate()
    fp32 = {"param_dtype": "float32", "compute_dtype": "float32"}
    return {"jamba32": dataclasses.replace(jamba, **fp32),
            "jamba16": dataclasses.replace(jamba, param_dtype="bfloat16"),
            "xlstm32": dataclasses.replace(get_config(XLSTM),
                                           num_layers=XLSTM_TP_DEPTH,
                                           **fp32).validate()}


def ssm_tp_serve(torch, cfg, prompts, mesh, new_tokens):
    """``cfg`` drawn by ``make_engine`` (on a mesh each rank its shards)
    -> the logits of prompt 0's prefill (every vocab column), the greedy
    tokens of every prompt, the seconds to draw, and the engine."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.serve import make_engine
    from repro_torch.serve import Request

    t0 = time.perf_counter()
    engine = make_engine(cfg.name, cfg=cfg, num_slots=2, max_len=256,
                         seed=0, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    ready = time.perf_counter() - t0
    with torch.inference_mode():
        logits, _, _ = engine.executor.prefill(prompts[0])
        with (contextlib.nullcontext() if mesh is None
              else tp.local_view(mesh)):
            logits = tp.gather_vocab(logits, engine.executor.model_cfg)
    for rid, prompt in prompts.items():
        engine.submit(Request(rid, prompt, max_new_tokens=new_tokens))
    done = engine.run()
    return logits, {rid: done[rid].generated for rid in prompts}, ready, \
        engine


def xlstm_train_run(torch, cfg, mesh):
    """Phase 30 b: xlstm-350m (fp32) DP_STEPS steps of 4 x
    XLSTM_TRAIN_SEQ tokens through the Trainer on ``mesh`` (None: one
    device) -> losses, grad norms, step walls, peak."""
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.train.steps import TrainHyper
    from repro_torch.train.trainer import Trainer

    data = SyntheticLMDataset(vocab_size=cfg.vocab_size,
                              seq_len=XLSTM_TRAIN_SEQ,
                              global_batch=TRAIN_BATCH, seed=0,
                              device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, TrainHyper(peak_lr=1e-3, warmup_steps=2,
                                      total_steps=DP_STEPS), data, seed=0,
                      log_every=1, mesh=mesh, checkpoint_every=10 ** 9,
                      device="cuda")
    trainer.train(DP_STEPS, trainer.init_or_restore())
    torch.cuda.synchronize()
    return {"losses": [r["loss"] for r in trainer.metrics_log],
            "grad_norms": [r["grad_norm"] for r in trainer.metrics_log],
            "step_ms": [r["sec_per_step"] * 1e3 for r in trainer.metrics_log],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def decode_step_ms(torch, executor, iters=10):
    """The median wall of ``iters`` batched decode steps over every lane
    (idle lanes at the scratch position), each synchronized."""
    tokens = torch.zeros((executor.num_slots, 1), dtype=torch.long)
    positions = torch.full((executor.num_slots,), executor.scratch_position,
                           dtype=torch.long)
    walls = []
    for _ in range(iters + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        executor.decode(tokens, positions)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return median(walls[2:])


def _ssm_fsdp_worker(rank, world, store, out_dir):
    """Phase 30, one rank: (a) jamba fp32 on (1, 2) [logits, tokens] and
    bf16 [phase 7's workload, launches, decode-step wall, peak], (b) xlstm
    fp32 training and tokens on (1, 2), (c) qwen3 FSDP on (2, 1) in fp32
    and (1, 2) with "act_seq" off in bf16; rank 0 holds the logits against
    the one-device run the parent saved."""
    import torch
    import torch.distributed as dist

    _tp_join(rank, world, store)
    try:
        from repro_torch.distributed import tensor_parallel as tp
        from repro_torch.launch.mesh import make_mesh

        out = Path(out_dir)
        counters = _tp_counters()
        given = torch.load(out / "ssm_in.pt", weights_only=False)
        cfgs = ssm_tp_configs()
        mesh = make_mesh((1, world), ("data", "model"), device_type="cuda")
        report = {}
        # a. jamba fp32: prefill logits and greedy tokens
        torch.cuda.reset_peak_memory_stats()
        logits, tokens, ready, engine = ssm_tp_serve(
            torch, cfgs["jamba32"], given["short"], mesh, SSM_NEW_TOKENS)
        report["jamba32"] = {
            "tokens": tokens, "ready_s": ready,
            "local_heads": engine.executor.model_cfg.num_heads,
            "local_d_inner": cfgs["jamba32"].mamba.expand
            * cfgs["jamba32"].d_model // tp.shards_of(
                engine.executor.model_cfg),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "finite": bool(torch.isfinite(logits).all())}
        if rank == 0:
            want = torch.load(out / "jamba32_logits.pt").cuda()
            report["jamba32"]["rel"] = rel_err(torch, logits, want)
            del want
        del logits, engine
        gc.collect()
        torch.cuda.empty_cache()
        # a. jamba bf16 weights at phase 27 c's depth: phase 7's workload
        torch.cuda.reset_peak_memory_stats()
        from repro_torch.launch.serve import make_engine

        t0 = time.perf_counter()
        engine = make_engine(JAMBA, cfg=cfgs["jamba16"], num_slots=4,
                             max_len=256, seed=0, device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        ready = time.perf_counter() - t0
        for c in counters.values():
            c.launches = 0
        done, admissions, steps, wall = run_workload(torch, engine,
                                                     given["prompts"], 0)
        launches = {k: c.launches for k, c in counters.items()
                    if c.launches}
        report["jamba16"] = {
            "launches": launches, "admissions": admissions, "steps": steps,
            "wall": wall, "ready_s": ready,
            "decode_ms": decode_step_ms(torch, engine.executor),
            "tokens": {rid: s_.generated for rid, s_ in done.items()},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del engine, done
        gc.collect()
        torch.cuda.empty_cache()
        # b. xlstm fp32: training, then greedy tokens
        report["xlstm_train"] = xlstm_train_run(torch, cfgs["xlstm32"], mesh)
        gc.collect()
        torch.cuda.empty_cache()
        _, tokens, _, engine = ssm_tp_serve(
            torch, cfgs["xlstm32"], given["short"], mesh, SSM_NEW_TOKENS)
        report["xlstm_tokens"] = tokens
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        # c. qwen3-1.7b: FSDP on (2, 1) in fp32, "act_seq" off on (1, 2)
        fsdp_mesh = make_mesh((world, 1), ("data", "model"),
                              device_type="cuda")
        report["fsdp"] = tp_train_run(torch, fsdp_mesh, "float32",
                                      leaves=False)
        gc.collect()
        torch.cuda.empty_cache()
        report["seq_off"] = tp_train_run(torch, mesh, "bfloat16",
                                         leaves=False,
                                         rules={"act_seq": None})
        (out / f"ssm{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def ssm_fsdp_phase(torch, np, kernels, prompts, tp_runs):
    """Phase 30 (see the module docstring): 2 gloo ranks on cuda:0 serve
    jamba-v0.1-52b (one pattern period) on (data 1, model 2) in fp32 and in
    bf16 weights, train and serve xlstm-350m on (1, 2), and train
    qwen3-1.7b with FSDP on (2, 1) (against phase 29 a's one-device fp32
    run, ``one_fp32``) and on (1, 2) with "act_seq" off (against phase
    29 a's bf16 ranks, where it is on; ``tp_runs``: what phase 29 a
    returned). Every check is fatal."""
    import tempfile

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cfgs = ssm_tp_configs()
    gen = torch.Generator(device="cpu")
    gen.manual_seed(30)
    short = {rid: torch.randint(0, cfgs["xlstm32"].vocab_size, (t,),
                                generator=gen).numpy()
             for rid, t in enumerate((JAMBA_TP_PROMPT_T, 5, 37))}
    # phase 27 c's requests: phase 7's lengths, ids in jamba's vocabulary
    rng = np.random.default_rng(0)
    own = {rid: rng.integers(0, cfgs["jamba16"].vocab_size, size=len(p_))
           for rid, p_ in prompts.items()}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        torch.save({"short": short, "prompts": own}, out / "ssm_in.pt")
        # one device first, each freed before the next and the ranks
        one = {}
        for tag in ("jamba32", "xlstm32"):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            logits, tokens, ready, engine = ssm_tp_serve(
                torch, cfgs[tag], short, None, SSM_NEW_TOKENS)
            one[tag] = {"tokens": tokens, "ready_s": ready,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            torch.save(logits.cpu(), out / f"{tag}_logits.pt")
            del logits, engine
        gc.collect()
        torch.cuda.empty_cache()
        one["xlstm_train"] = xlstm_train_run(torch, cfgs["xlstm32"], None)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        spawn_ranks(_ssm_fsdp_worker, TP_RANKS, str(out / "s_ssm"), tmp)
        spawn_s = time.perf_counter() - t0
        reps = [json.loads((out / f"ssm{r}.json").read_text())
                for r in range(TP_RANKS)]

    def keyed(tokens):
        return {int(k): v for k, v in tokens.items()}

    # a. jamba fp32: logits held, tokens printed with where they part
    r0 = reps[0]["jamba32"]
    tok = keyed(r0["tokens"])
    print(f"[ssm-tp a] {JAMBA} rm fp32, {JAMBA_DEPTH} layers, on (data 1, "
          f"model {TP_RANKS}), {TP_RANKS} gloo processes on cuda:0 "
          f"({spawn_s:.1f}s for all of phase 30's mesh runs with their "
          f"start-up): prefill T {JAMBA_TP_PROMPT_T} logits {r0['rel']:.3e} "
          f"from one device's (budget {E2E_TOL:.0e}); greedy tokens of "
          f"{len(short)} prompts (T "
          + ", ".join(str(len(p_)) for p_ in short.values()) + ") "
          f"equal one device's {tok == one['jamba32']['tokens']}, part at "
          f"{parting_points(tok, one['jamba32']['tokens'])}; per rank "
          + "; ".join(f"rank {r} {rep['jamba32']['local_heads']} heads, "
                      f"d_inner {rep['jamba32']['local_d_inner']}, drawn in "
                      f"{rep['jamba32']['ready_s']:.2f}s, peak "
                      f"{rep['jamba32']['peak_gib']:.2f} GiB"
                      for r, rep in enumerate(reps))
          + f" (one device {one['jamba32']['peak_gib']:.2f} GiB, drawn in "
          f"{one['jamba32']['ready_s']:.2f}s)")
    if not (r0["rel"] <= E2E_TOL and all(rep["jamba32"]["finite"]
                                         for rep in reps)
            and reps[0]["jamba32"]["tokens"] == reps[1]["jamba32"]["tokens"]):
        raise AssertionError("30 a: jamba fp32 on the mesh failed")
    # a. jamba bf16 weights: one B2 a prefill, one B1 a decode step a rank
    for r, rep in enumerate(reps):
        j = rep["jamba16"]
        print(f"[ssm-tp a] {JAMBA} rm bf16 weights, {JAMBA_DEPTH} layers, "
              f"phase 7's workload on (1, {TP_RANKS}), rank {r}: launches "
              f"{j['launches']} over {j['admissions']} admissions and "
              f"{j['steps']} decode steps, {j['wall']:.3f}s; a decode step "
              f"(4 lanes) {j['decode_ms']:.2f} ms wall (median of 10); drawn "
              f"in {j['ready_s']:.2f}s; peak {j['peak_gib']:.2f} GiB (phase "
              f"27 c, one device: {kernels['B2'].get('jamba_peak_gib', 0):.2f}"
              " GiB)")
        if j["launches"] != {"B1": j["steps"], "B2": j["admissions"]}:
            raise AssertionError(f"30 a: jamba bf16 rank {r} launches "
                                 f"{j['launches']}")
    if reps[0]["jamba16"]["tokens"] != reps[1]["jamba16"]["tokens"]:
        raise AssertionError("30 a: the jamba bf16 ranks disagree")
    kernels["B1"]["tp_jamba_launches_per_rank"] = \
        reps[0]["jamba16"]["launches"]["B1"]
    kernels["B2"]["tp_jamba_launches_per_rank"] = \
        reps[0]["jamba16"]["launches"]["B2"]
    kernels["B1"]["tp_jamba_decode_step_ms"] = reps[0]["jamba16"]["decode_ms"]
    kernels["B2"]["tp_jamba_peak_gib_per_rank"] = max(
        rep["jamba16"]["peak_gib"] for rep in reps)

    # b. xlstm-350m fp32 training and tokens
    x0, x1 = one["xlstm_train"], reps[0]["xlstm_train"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(x1["losses"], x0["losses"])]
    ngaps = [abs(a - b) / abs(b) for a, b in zip(x1["grad_norms"],
                                                 x0["grad_norms"])]
    xtok = keyed(reps[0]["xlstm_tokens"])
    print(f"[ssm-tp b] {XLSTM} fp32 at full width, {XLSTM_TP_DEPTH} of 24 "
          f"layers, {DP_STEPS} "
          f"steps of {TRAIN_BATCH} x {XLSTM_TRAIN_SEQ} tokens on (1, "
          f"{TP_RANKS}): losses " + " ".join(f"{v:.6f}" for v in x1["losses"])
          + " against one device's " + " ".join(f"{v:.6f}"
                                                for v in x0["losses"])
          + "; gaps " + " ".join(f"{v:.2e}" for v in gaps) + "; grad_norm "
          "gaps " + " ".join(f"{v:.2e}" for v in ngaps)
          + f" (budget {TP_FP32_TOL:.0e}); step walls "
          + " / ".join(f"{v:.0f}" for v in x1["step_ms"]) + " ms (one device "
          + " / ".join(f"{v:.0f}" for v in x0["step_ms"]) + " ms); peak a "
          f"rank {x1['peak_gib']:.2f} GiB (one device {x0['peak_gib']:.2f});"
          " greedy tokens equal one device's "
          f"{xtok == one['xlstm32']['tokens']}, part at "
          f"{parting_points(xtok, one['xlstm32']['tokens'])}")
    if not (max(gaps + ngaps) <= TP_FP32_TOL
            and reps[0]["xlstm_train"]["losses"]
            == reps[1]["xlstm_train"]["losses"]
            and reps[0]["xlstm_tokens"] == reps[1]["xlstm_tokens"]):
        raise AssertionError("30 b: xlstm on the mesh failed")

    # c. qwen3-1.7b: FSDP on (2, 1) in fp32; "act_seq" off on (1, 2)
    one_fp32 = tp_runs["one_fp32"]
    f0 = reps[0]["fsdp"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(f0["losses"],
                                                one_fp32["losses"])]
    ngaps = [abs(a - b) / abs(b) for a, b in zip(f0["grad_norms"],
                                                 one_fp32["grad_norms"])]
    want_b2 = [train_launches(get_config("qwen3-1.7b"))] * DP_STEPS
    print(f"[fsdp c] qwen3-1.7b rm fp32, {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
          f"(2 rows a rank), {DP_STEPS} steps with FSDP on (data "
          f"{TP_RANKS}, model 1): losses "
          + " ".join(f"{v:.6f}" for v in f0["losses"]) + " against one "
          "device's (phase 29 a) " + " ".join(f"{v:.6f}"
                                               for v in one_fp32["losses"])
          + "; gaps " + " ".join(f"{v:.2e}" for v in gaps) + "; grad_norm "
          "gaps " + " ".join(f"{v:.2e}" for v in ngaps)
          + f" (budget {TP_FP32_TOL:.0e})")
    for r, rep in enumerate(reps):
        f_ = rep["fsdp"]
        print(f"[fsdp c] rank {r}: train state (params, mu, nu) "
              f"{f_['state_gib']:.2f} GiB (one device "
              f"{one_fp32['state_gib']:.2f}), peak {f_['peak_gib']:.2f} GiB "
              f"(one device {one_fp32['peak_gib']:.2f}; phase 24 c, "
              f"{TRAIN_DEPTH} layers, {kernels['B2']['train_peak_gib']:.2f} "
              f"GiB), B2 a step "
              f"{f_['b2']}, step walls "
              + " / ".join(f"{v:.1f}" for v in f_["step_ms"])
              + f" ms (one device {one_fp32['step_ms'][-1]:.1f} warm)")
    off = [rep["seq_off"] for rep in reps]
    print(f"[fsdp c] qwen3-1.7b rm bf16 on (1, {TP_RANKS}) with \"act_seq\" "
          "off (the replicated path): peak a rank "
          + " / ".join(f"{o['peak_gib']:.2f}" for o in off) + " GiB against "
          f"{kernels['B2']['tp_train_peak_gib_per_rank']:.2f} GiB with it on "
          "(phase 29 a); losses "
          + " ".join(f"{v:.6f}" for v in off[0]["losses"]) + ", with it on "
          + " ".join(f"{v:.6f}" for v in tp_runs["bf16_mesh_losses"])
          + "; step walls " + " / ".join(f"{v:.1f}" for v in off[0]["step_ms"])
          + " ms")
    if not (max(gaps + ngaps) <= TP_FP32_TOL
            and reps[0]["fsdp"]["losses"] == reps[1]["fsdp"]["losses"]
            and all(rep["fsdp"]["b2"] == want_b2 for rep in reps)
            and all(rep["fsdp"]["state_gib"] < 0.6 * one_fp32["state_gib"]
                    for rep in reps)
            and off[0]["losses"] == off[1]["losses"]):
        raise AssertionError("30 c: FSDP or act_seq training failed")
    kernels["B2"]["fsdp_train_launches_per_rank_step"] = f0["b2"][0]
    kernels["B2"]["fsdp_train_peak_gib_per_rank"] = max(
        rep["fsdp"]["peak_gib"] for rep in reps)
    kernels["B2"]["fsdp_state_gib_per_rank"] = f0["state_gib"]
    kernels["B2"]["seq_off_train_peak_gib_per_rank"] = max(
        o["peak_gib"] for o in off)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[ssm-tp] phase 30 in {time.perf_counter() - t_phase:.2f}s")


# -- phase 31: remat, the dry run against the card, weights cut over "data"
REMAT_OFF_PEAK_GIB = 36.80     # PERF.md §5: the qwen3 step's peak, no remat
HUBERT_OFF_PEAK_GIB = 45.84    # PERF.md: hubert-xlarge's step, no remat
H100_BF16_TFLOPS = 989.0       # dense bf16 on the tensor cores
CUT_SERVE_REQUESTS = 2         # phase 7's first requests in phase 31 c: a
# decode step gathers every block's weights over gloo, through the host
REMAT_LOSS_TOL = 1e-6          # relative, fp32, if bf16 is not bitwise


def dryrun_predictions():
    """Phase 31 b's dry runs (no card: ``meta`` tensors over a fake
    process group of one rank): qwen3-1.7b rm's train step at phase 24
    c's shape with remat on and off, and phase 7's decode step (4 slots,
    max_len 256) -> their records by name."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeSpec

    cfg = get_config("qwen3-1.7b", attention_mode="rm")
    train = ShapeSpec("train_4x256", TRAIN_SEQ, TRAIN_BATCH, "train")
    decode = ShapeSpec("decode_4x256", 256, 4, "decode")
    out = {}
    with dryrun.dry_world(1):
        mesh = dryrun._mesh("one")
        for remat in (True, False):
            out[f"train_remat_{remat}"] = dryrun.measure(
                dc.replace(cfg, remat=remat), train, mesh, "one")
        out["decode"] = dryrun.measure(cfg, decode, mesh, "one")
    return out


def _cut_serve_worker(rank, world, store, out_dir):
    """Phase 31 c, one rank: phase 7's first CUT_SERVE_REQUESTS requests
    through ``make_engine(mesh=)`` on (data 2, model 1), first with the
    weights cut over "data" (the default "fsdp" rule), then whole
    (``rules={"fsdp": None}``): tokens, B1 / B2 launches, the bytes of the
    weights a rank holds (fp32 masters and the bf16 compute copy), its
    peak above what it held before, and the median wall of 3 decode
    steps over all lanes."""
    import statistics

    import torch
    import torch.distributed as dist

    _tp_join(rank, world, store)
    try:
        from repro_torch.common.tree import tree_leaves
        from repro_torch.distributed.sharding import logical_rules_context
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.serve import make_engine

        out = Path(out_dir)
        counters = _tp_counters()
        given = torch.load(out / "cut_in.pt", weights_only=False)
        mesh = make_mesh((world, 1), ("data", "model"), device_type="cuda")
        report = {}
        for label, rules in (("cut", None), ("whole", {"fsdp": None})):
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with logical_rules_context(mesh, rules):
                engine = make_engine("qwen3-1.7b", smoke=False,
                                     attention_mode="rm", num_slots=4,
                                     max_len=256, seed=0, device="cuda",
                                     mesh=mesh)
            ex = engine.executor
            for c in counters.values():
                c.launches = 0
            done, admissions, steps, wall = run_workload(
                torch, engine, given["prompts"], 0)
            launches = {k: c.launches for k, c in counters.items()
                        if c.launches}
            tokens = torch.zeros((4, 1), dtype=torch.long)
            positions = torch.full((4,), ex.scratch_position,
                                   dtype=torch.int32)
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ex.decode(tokens, positions)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            nbytes = {key: sum(t_.numel() * t_.element_size()
                               for t_ in tree_leaves(tree))
                      for key, tree in (("masters", ex.params),
                                        ("compute", ex.compute_params))}
            report[label] = {
                "tokens": {rid: s_.generated for rid, s_ in done.items()},
                "launches": launches, "admissions": admissions,
                "steps": steps, "wall": wall,
                "decode_ms": statistics.median(walls) * 1e3,
                "weight_bytes": nbytes, "cut": ex._plan is not None,
                "peak_gib": (torch.cuda.max_memory_allocated() - base)
                / 2**30}
            del engine, ex
        (out / f"cut{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def remat_dryrun_phase(torch, np, kernels, prompts):
    """Phase 31 (see the module docstring): (a) remat on qwen3-1.7b's
    train step against remat off, hubert's remat step (phase 24 d); (b)
    the dry run's predictions (:func:`dryrun_predictions`, run here after
    (a)'s timings) against the card; (c) phase 7's first requests served
    on (2, 1) with the weights cut over "data" and whole. Every check is
    fatal."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_engine

    t_phase = time.perf_counter()
    cfg = get_config("qwen3-1.7b", attention_mode="rm")

    # a. remat on and off: 3 bf16 steps each from seed 0
    runs = {}
    for remat in (True, False):
        runs[remat] = tp_train_run(torch, None, "bfloat16", leaves=False,
                                   remat=remat)
        gc.collect()
        torch.cuda.empty_cache()
    on, off = runs[True], runs[False]
    bitwise = on["losses"] == off["losses"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(on["losses"], off["losses"])]
    want = {True: train_launches(cfg), False: cfg.num_layers}
    for remat, r in runs.items():
        print(f"[remat a] qwen3-1.7b rm bf16, {TRAIN_BATCH} x {TRAIN_SEQ} "
              f"tokens, remat {remat}: losses "
              + " ".join(f"{v:.6f}" for v in r["losses"])
              + f"; B2 a step {r['b2']} (want {want[remat]}); step walls "
              + " / ".join(f"{v:.1f}" for v in r["step_ms"])
              + f" ms (warm {r['step_ms'][-1]:.1f}); peak "
              f"{r['peak_gib']:.2f} GiB ({r['peak_gib'] - r['base_gib']:.2f}"
              f" above the {r['base_gib']:.2f} GiB held before; before "
              f"remat: {REMAT_OFF_PEAK_GIB:.2f} GiB)")
    print(f"[remat a] losses bitwise equal {bitwise}; gaps "
          + " ".join(f"{v:.2e}" for v in gaps))
    if not all(r["b2"] == [want[m]] * DP_STEPS for m, r in runs.items()):
        raise AssertionError("31 a: B2 launches a step")
    if not bitwise:
        fp32 = {m: tp_train_run(torch, None, "float32", leaves=False,
                                remat=m) for m in (True, False)}
        gaps32 = [abs(a - b) / abs(b) for a, b in
                  zip(fp32[True]["losses"], fp32[False]["losses"])]
        print("[remat a] fp32 losses gaps " + " ".join(f"{v:.2e}"
                                                       for v in gaps32)
              + f" (tol {REMAT_LOSS_TOL:.0e})")
        if max(gaps32) > REMAT_LOSS_TOL:
            raise AssertionError("31 a: fp32 remat losses part")
    h_peak = kernels["B3"]["train_peak_gib"]
    print(f"[remat a] hubert-xlarge one step on {ENC_TRAIN_CLIPS} x "
          f"{ENC_FRAMES} frames with remat (phase 24 d): B3 and B4 "
          f"{kernels['B3']['train_step_launches']} each, peak {h_peak:.2f} "
          f"GiB (before remat: {HUBERT_OFF_PEAK_GIB:.2f} GiB)")
    kernels["B2"]["remat_train_launches_per_step"] = on["b2"][-1]
    kernels["B2"]["no_remat_train_launches_per_step"] = off["b2"][-1]
    kernels["B2"]["remat_train_peak_gib"] = on["peak_gib"]
    kernels["B2"]["no_remat_train_peak_gib"] = off["peak_gib"]

    # b. the dry run's predictions against the card
    t_dry = time.perf_counter()
    pred = dryrun_predictions()
    print(f"[dryrun b] the three dry runs took "
          f"{time.perf_counter() - t_dry:.1f} s on the host")
    gc.collect()
    torch.cuda.empty_cache()
    for remat, r in runs.items():
        rec = pred[f"train_remat_{remat}"]
        ma = rec["memory_analysis"]
        state = ma["argument_parts"]["state"]
        want_gib = (ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]) \
            / 2**30
        card = r["peak_gib"] - r["base_gib"]
        warm_s = r["step_ms"][-1] / 1e3
        flops, mf = rec["per_device_flops"], rec["model_flops"]
        print(f"[dryrun b] train remat {remat}: state {state} B predicted, "
              f"{r['state_bytes']} B on the card; peak {want_gib:.2f} GiB "
              "predicted (arguments "
              f"{ma['argument_size_in_bytes'] / 2**30:.2f} + temp "
              f"{ma['temp_size_in_bytes'] / 2**30:.2f}) against "
              f"{card:.2f} on the card ({100 * (want_gib - card) / card:+.1f}"
              f"%); counted {flops / 1e12:.3f} TFLOP, model_flops "
              f"{mf / 1e12:.3f} TFLOP over the warm step "
              f"{warm_s * 1e3:.1f} ms: {flops / warm_s / 1e12:.1f} / "
              f"{mf / warm_s / 1e12:.1f} TFLOP/s, "
              f"{100 * flops / warm_s / 1e12 / H100_BF16_TFLOPS:.2f}% / "
              f"{100 * mf / warm_s / 1e12 / H100_BF16_TFLOPS:.2f}% of "
              f"{H100_BF16_TFLOPS:.0f}; meta run {rec['meta_s']:.1f}s")
        if state != r["state_bytes"]:
            raise AssertionError(f"31 b: predicted state bytes {state} "
                                 f"against {r['state_bytes']}")
        kernels["B2"][f"dryrun_train_remat_{remat}_peak_err"] = \
            (want_gib - card) / card
    base = torch.cuda.memory_allocated()
    engine = make_engine("qwen3-1.7b", smoke=False, attention_mode="rm",
                         num_slots=4, max_len=256, seed=0, device="cuda")
    ex = engine.executor
    tokens = torch.zeros((4, 1), dtype=torch.long)
    positions = torch.full((4,), ex.scratch_position, dtype=torch.int32)
    ex.decode(tokens, positions)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ex.decode(tokens, positions)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    card = (torch.cuda.max_memory_allocated() - base) / 2**30
    masters = sum(t_.numel() * t_.element_size()
                  for t_ in tree_leaves(ex.params))
    rec = pred["decode"]
    ma = rec["memory_analysis"]
    want_gib = (ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]) \
        / 2**30
    print(f"[dryrun b] decode step (4 slots, max_len 256): weights "
          f"{ma['argument_parts']['params']} B predicted, {masters} B on the "
          f"card; peak {want_gib:.3f} GiB predicted (arguments "
          f"{ma['argument_size_in_bytes'] / 2**30:.3f} + temp "
          f"{ma['temp_size_in_bytes'] / 2**30:.3f}, the compute copy made "
          f"in the step) against {card:.3f} GiB on the card "
          f"({100 * (want_gib - card) / card:+.1f}%); counted "
          f"{rec['per_device_flops'] / 1e9:.2f} GFLOP over a "
          f"{dec_s * 1e3:.1f} ms step")
    if ma["argument_parts"]["params"] != masters:
        raise AssertionError("31 b: predicted weight bytes differ")
    kernels["B1"]["dryrun_decode_peak_err"] = (want_gib - card) / card
    del engine, ex
    gc.collect()
    torch.cuda.empty_cache()

    # c. phase 7's first requests on (2, 1), the weights cut and whole
    first = dict(list(prompts.items())[:CUT_SERVE_REQUESTS])
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        torch.save({"prompts": first}, out / "cut_in.pt")
        t0 = time.perf_counter()
        spawn_ranks(_cut_serve_worker, TP_RANKS, str(out / "s_cut"), tmp)
        spawn_s = time.perf_counter() - t0
        reps = [json.loads((out / f"cut{r}.json").read_text())
                for r in range(TP_RANKS)]
    ok = True
    for r, rep in enumerate(reps):
        for label in ("cut", "whole"):
            x = rep[label]
            gib = {k: v / 2**30 for k, v in x["weight_bytes"].items()}
            print(f"[cut c] rank {r}, weights {label} (cut over data "
                  f"{x['cut']}): {x['admissions']} admissions, "
                  f"{x['steps']} decode steps in {x['wall']:.2f}s, launches "
                  f"{x['launches']}; weights held {gib['masters']:.2f} GiB "
                  f"fp32 + {gib['compute']:.2f} GiB bf16; peak "
                  f"{x['peak_gib']:.2f} GiB above what it held; decode "
                  f"step {x['decode_ms']:.1f} ms")
            layers = cfg.num_layers
            ok = ok and (x["launches"].get("B1", 0) == layers * x["steps"]
                         and x["launches"].get("B2", 0) % layers == 0)
        ok = ok and (rep["cut"]["tokens"] == rep["whole"]["tokens"]
                     and rep["cut"]["cut"] and not rep["whole"]["cut"]
                     and rep["cut"]["launches"] == rep["whole"]["launches"]
                     and rep["cut"]["weight_bytes"]["masters"]
                     < 0.6 * rep["whole"]["weight_bytes"]["masters"])
    b2 = sum(rep["cut"]["launches"].get("B2", 0) for rep in reps)
    ok = ok and b2 == cfg.num_layers * CUT_SERVE_REQUESTS and \
        reps[0]["cut"]["tokens"] == reps[1]["cut"]["tokens"]
    same = all(rep["cut"]["tokens"] == rep["whole"]["tokens"] for rep in reps)
    agree = reps[0]["cut"]["tokens"] == reps[1]["cut"]["tokens"]
    print(f"[cut c] phase 7's first {CUT_SERVE_REQUESTS} requests on (data "
          f"{TP_RANKS}, model 1), {spawn_s:.1f}s with the start-up: tokens "
          f"equal with the weights cut and whole {same}, ranks agree "
          f"{agree}, B2 over the ranks {b2}")
    if not ok:
        raise AssertionError("31 c: serving with the weights cut over "
                             "'data' failed")
    for kid in ("B1", "B2"):
        kernels[kid]["cut_serve_launches_per_rank"] = \
            reps[0]["cut"]["launches"].get(kid, 0)
    print(f"[remat] phase 31 in {time.perf_counter() - t_phase:.2f}s")


# -- phase 32: the bucketed engine; the SMOKE-only configs at full width ----
MIXTRAL_DEPTH = 8          # of mixtral-8x7b's 32 layers: about 24 GB in bf16
# (arch, depth or None for the config's own): phase 7's workload at full
# width in rm mode, bf16 weights drawn on the card
FULL_WIDTH_CASES = (("olmo-1b", None), ("h2o-danube-3-4b", None),
                    ("qwen2-7b", None), ("internvl2-1b", None),
                    ("mixtral-8x7b", MIXTRAL_DEPTH))


def engine_run(torch, engine, prompts, base):
    """Phase 7's workload (greedy, 16 new tokens a request, ids ``base +
    i``) through a ``ServingEngine`` built with an ``Obs``, whose token
    latency histogram counts its decode iterations -> (finished states by
    request, decode iterations, wall seconds)."""
    from repro_torch.serve import Request

    for rid, prompt in prompts.items():
        engine.submit(Request(base + rid, prompt, max_new_tokens=16))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finished = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = engine.obs.metrics.histogram("serve/token_latency_s").count
    return {rid: finished[base + rid] for rid in prompts}, steps, wall


def bucketed_engine_checks(torch, np, kernels, counters, prompts,
                           rm_tokens):
    """Phase 32 a: qwen3 SMOKE rm in fp32 through ``ServingEngine`` on the
    card and the CPU, greedy tokens identical (the gate) and B2 / B1 once
    a layer a prefill / decode step; then qwen3-1.7b at full width through
    ``make_engine(scheduler="bucketed")`` on phase 7's workload: B2 and
    B1 launches, and the tokens' agreement with phase 7's Scheduler's
    (printed: bf16 decode rows depend on the lanes decoded together)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_engine
    from repro_torch.models import transformer as tt
    from repro_torch.obs import Obs
    from repro_torch.serve import ServingEngine

    scfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True,
                                          attention_mode="rm"),
                               compute_dtype="float32")
    p_cpu = tt.init_model(scfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(32)
    small = {rid: rng.integers(0, scfg.vocab_size, size=n)
             for rid, n in enumerate((3, 17, 33, 40, 9))}
    got, card_launches = {}, None
    for dev, params in (("cuda", tree_to(p_cpu, "cuda")), ("cpu", p_cpu)):
        for fn in counters.values():
            fn.launches = 0
        engine = ServingEngine(scfg, params, num_slots=2, max_len=64,
                               device=dev, obs=Obs())
        done, steps, _ = engine_run(torch, engine, small, 0)
        got[dev] = {rid: s_.generated for rid, s_ in done.items()}
        if dev == "cuda":
            card_launches = ({k: fn.launches for k, fn in counters.items()
                              if fn.launches}, steps)
    layers = scfg.num_layers
    launches, steps = card_launches
    want = {"B1": layers * steps, "B2": layers * len(small)}
    print(f"[engine] qwen3 SMOKE rm fp32 through ServingEngine, card vs "
          f"CPU: greedy tokens of {len(small)} requests identical "
          f"{got['cuda'] == got['cpu']}; card launches {launches} over "
          f"{steps} decode iterations (want {want})")
    if got["cuda"] != got["cpu"] or launches != want or \
            not all(len(t_) == 16 for t_ in got["cuda"].values()):
        raise AssertionError("the bucketed engine's SMOKE card vs CPU "
                             "check failed")

    cfg = get_config("qwen3-1.7b", attention_mode="rm")
    engine = make_engine("qwen3-1.7b", smoke=False, attention_mode="rm",
                         num_slots=4, max_len=256, seed=0, device="cuda",
                         obs=Obs(), scheduler="bucketed")
    if not isinstance(engine, ServingEngine):
        raise AssertionError("make_engine(scheduler='bucketed') did not "
                             "return a ServingEngine")
    for fn in counters.values():
        fn.launches = 0
    done, steps, wall = engine_run(torch, engine, prompts, 0)
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    tokens = {rid: s_.generated for rid, s_ in done.items()}
    same_req = sum(tokens[r] == rm_tokens[r] for r in prompts)
    same_tok = sum(a == b for r in prompts
                   for a, b in zip(tokens[r], rm_tokens[r]))
    n_tok = sum(len(t_) for t_ in rm_tokens.values())
    layers = cfg.num_layers
    want = {"B1": layers * steps, "B2": layers * len(prompts)}
    print(f"[engine] qwen3-1.7b rm at full width through make_engine("
          f"scheduler='bucketed'), phase 7's workload: "
          f"{sum(len(t_) for t_ in tokens.values())} tokens in {wall:.3f}s, "
          f"launches {launches} over {steps} decode iterations (want "
          f"{want}: B2 {layers} a prefill, B1 {layers} a decode step); "
          f"tokens beside phase 7's Scheduler's: {same_req} of "
          f"{len(prompts)} requests and {same_tok} of {n_tok} tokens "
          "identical (bf16; not gated)")
    if launches != want or any(s_.finish_reason not in VALID_REASONS
                               for s_ in done.values()):
        raise AssertionError("the bucketed engine's full-width serve "
                             "failed")
    kernels["B1"]["engine_launches"] = launches["B1"]
    kernels["B2"]["engine_launches"] = launches["B2"]
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def full_width_phase(torch, np, kernels, counters, prompts, rm_tokens):
    """Phase 32 (see the module docstring): (a) the bucketed engine, (b)
    olmo-1b, h2o-danube-3-4b, qwen2-7b and internvl2-1b at full width and
    depth and mixtral-8x7b at full width with MIXTRAL_DEPTH layers, each in
    rm mode with bf16 weights on phase 7's workload: B2 once a layer a
    prefill and B1 once a layer a decode step (each first held against its
    plain version at the model's shapes, on a plan drawn for its head
    width), peak memory beside the weights' bytes, TTFT and tokens/s cold
    and warm, and one profiler window of a decode step and of the
    bucket-256 prefill. Every check is fatal."""
    from repro_torch.configs import get_config
    from repro_torch.core.plan import init_omegas, pack_omegas, plan_columns
    from repro_torch.launch.serve import make_engine
    from repro_torch.models.attention import rm_plan_for

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(32)
    bucketed_engine_checks(torch, np, kernels, counters, prompts, rm_tokens)
    for arch, depth in FULL_WIDTH_CASES:
        cfg = get_config(arch, attention_mode="rm")
        if depth is not None:
            cfg = dataclasses.replace(cfg, num_layers=depth).validate()
        tag = arch.split("-")[0]
        # B2 at the bucket-256 prefill, B1 at the decode shape
        dh, heads = cfg.resolved_head_dim, cfg.num_heads
        plan = rm_plan_for(cfg, dh)
        w32 = pack_omegas(plan, init_omegas(plan, gen))
        cd, cs = plan_columns(plan, "cuda")
        print(f"[{tag} plan] rm at head width {dh}: packed w "
              f"{tuple(w32.shape)}, F={plan.output_dim}; {heads} heads")
        # events only: after phases 28-31 the profiler has returned
        # windows of these short calls without a device event
        kernels["B2"].update(prefixed(tag, b2_shape_check(
            torch, np, gen, w32, cd, cs, heads, dh, cfg.rm.eps, 256, 56,
            tag, profile=False)))
        kernels["B1"].update(prefixed(tag, b1_shape_check(
            torch, np, gen, w32, cd, cs, 2 * 4 * heads, tag,
            profile=False)))
        del w32
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = make_engine(arch, cfg=cfg, num_slots=4, max_len=256,
                             seed=0, device="cuda", param_dtype="bfloat16")
        torch.cuda.synchronize()
        ready_s = time.perf_counter() - t0
        n_params = sum(p_.numel()
                       for p_ in tree_leaves(engine.executor.params))
        p_bytes = sum(p_.numel() * p_.element_size()
                      for p_ in tree_leaves(engine.executor.params))
        state_bytes = sum(t_.numel() * t_.element_size()
                          for t_ in tree_leaves(engine.executor.cache))
        extra = []
        if cfg.sliding_window:
            extra.append(f"sliding window {cfg.sliding_window} (rm mode "
                         "reads every position)")
        if cfg.qkv_bias:
            extra.append("QKV bias")
        if cfg.frontend == "vision_stub":
            extra.append("vision_stub frontend served on tokens, as the "
                         "reference's executor serves it")
        if cfg.moe is not None:
            extra.append(f"{cfg.moe.num_experts} experts top-"
                         f"{cfg.moe.top_k}, d_ff_expert "
                         f"{cfg.moe.d_ff_expert}")
        cut = (f"depth cut from {get_config(arch).num_layers} to "
               f"{cfg.num_layers}" if depth is not None else "depth not cut")
        print(f"[{tag}] {cfg.name}: {cfg.num_layers} layers ({cut}), "
              f"d_model {cfg.d_model}, {cfg.num_heads} heads / "
              f"{cfg.num_kv_heads} kv of {cfg.resolved_head_dim}, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab_size}, tied "
              f"{cfg.tie_embeddings}"
              + "".join(f", {e}" for e in extra)
              + f"; rm attention; {n_params / 1e9:.3f} B parameters, "
              f"{p_bytes / 2**30:.2f} GiB of weights (bf16), ready in "
              f"{ready_s:.2f}s; decode state {state_bytes / 2**20:.2f} MiB "
              "(4 lanes)")
        done, launches, admissions, steps, own = serve_full_width(
            torch, np, tag, engine, cfg, prompts, counters)
        peak = torch.cuda.max_memory_allocated()
        layers = cfg.num_layers
        print(f"[{tag}] B2 {launches.get('B2', 0) / admissions:g} a prefill "
              f"and B1 {launches.get('B1', 0) / steps:g} a decode step "
              f"({layers} layers); peak memory {peak / 2**30:.2f} GiB beside "
              f"{p_bytes / 2**30:.2f} GiB of weights "
              f"({peak / p_bytes:.2f}x)")
        if launches != {"B1": steps * layers, "B2": admissions * layers}:
            raise AssertionError(f"{arch} launches {launches}: want B2 "
                                 f"{layers} a prefill ({admissions}), B1 "
                                 f"{layers} a decode step ({steps})")
        shares = where_time_goes(
            torch, tag, engine, own, done,
            families={"B1": ("rm_feature_kernel",), "B2": ("chunk_",)})
        for kid, window in (("B1", "decode step"),
                            ("B2", "prefill bucket 256")):
            kernels[kid].setdefault("full_width", {})[arch] = {
                "launches": launches[kid],
                "per_call": launches[kid] // (steps if kid == "B1"
                                              else admissions),
                "window_device_ms": shares[window][kid],
                "peak_gib": peak / 2**30, "weights_gib": p_bytes / 2**30}
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[full] phase 32 in {time.perf_counter() - t_phase:.2f}s")


# -- phase 33: the dry run's last three levers as rules the model reads --
KV_RULES = {"kv_seq": "model", "kv_heads": None}     # kv_seq_shard
VOCAB_RULES = {"vocab": None}                        # vocab_unsharded
SP_RULES = {"act_seq": ("data",)}                    # sp_data
LEVER_STEPS = 3          # qwen3-1.7b train steps a run in phase 33 b-c
LEVER_LOSS_TOL = 2e-7    # relative, fp32: the vocabulary whole against cut
SP_SEQ = 256             # tokens of sp_data's one row (batch 1)
SP_DEPTH = 4             # qwen3-1.7b layers in 33 c (cut from TRAIN_DEPTH)
LEVER_NEW_TOKENS = 8     # greedy tokens a SMOKE request in phase 33 a
LEVER_MAX_LEN = 256      # 33 a's ring buffer: rank r holds r * 128 + [0, 128)
# phase 7's longest requests the head-cut control and one device's fp32
# serve in 33 a (cut from 8, for time), and those of them served in fp32
# on the mesh: 130 and 200 tokens, so every decode step reads both ranks'
# slots
LEVER_CONTROL_REQUESTS = 4
LEVER_FP32_REQUESTS = 2


def lever_train_run(torch, mesh, rules, batch, seq, steps=LEVER_STEPS,
                    depth=TRAIN_DEPTH):
    """Phase 33 b-c: qwen3-1.7b rm in fp32 at full width, ``depth`` of its
    layers, ``steps`` steps of ``batch`` x ``seq`` tokens through the
    Trainer on ``mesh`` (None: one device) under ``rules`` (None: the
    defaults) -> losses, grad_norms, B2 launches a step, the peak and the
    step walls."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.distributed.sharding import logical_rules_context
    from repro_torch.train.steps import TrainHyper
    from repro_torch.train.trainer import Trainer

    b2 = _tp_counters()["B2"]
    cfg = dataclasses.replace(get_config("qwen3-1.7b", attention_mode="rm"),
                              compute_dtype="float32",
                              num_layers=depth).validate()
    data = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=seq,
                              global_batch=batch, seed=0, device="cuda")
    hyper = TrainHyper(peak_lr=1e-3, warmup_steps=2, total_steps=steps)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches = []
    with (contextlib.nullcontext() if mesh is None or rules is None
          else logical_rules_context(mesh, rules)):
        trainer = Trainer(cfg, hyper, data, seed=0, log_every=1, mesh=mesh,
                          checkpoint_every=10 ** 9, device="cuda")
        state = trainer.init_or_restore()
        for step in range(1, steps + 1):
            b2.launches = 0
            state = trainer.train(step, state)
            torch.cuda.synchronize()
            launches.append(b2.launches)
    del state
    return {"losses": [r["loss"] for r in trainer.metrics_log],
            "grad_norms": [r["grad_norm"] for r in trainer.metrics_log],
            "step_ms": [r["sec_per_step"] * 1e3 for r in trainer.metrics_log],
            "b2": launches, "want_b2": train_launches(cfg),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def smoke_exact_serve(torch, prompts, mesh=None):
    """Phase 33 a: qwen3 SMOKE in exact attention and fp32 drawn from seed
    0 (a rank's shards on ``mesh``, under KV_RULES) serving ``prompts``
    greedily -> {request: tokens}."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import logical_rules_context
    from repro_torch.serve import Request, Scheduler
    from repro_torch.train.steps import init_params

    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              compute_dtype="float32")
    with (contextlib.nullcontext() if mesh is None
          else logical_rules_context(mesh, KV_RULES)):
        params = init_params(cfg, 0, "cuda") if mesh is None else \
            tp.init_local_params(cfg, 0, mesh, "cuda")[0]
        sched = Scheduler(cfg, params, num_slots=2, max_len=64,
                          device="cuda", mesh=mesh)
        for rid, prompt in prompts.items():
            sched.submit(Request(rid, prompt,
                                 max_new_tokens=LEVER_NEW_TOKENS))
        done = sched.run()
    return {rid: done[rid].generated for rid in prompts}


def exact_engine(mesh=None, dtype="bfloat16", rules=KV_RULES):
    """Phase 33 a: qwen3-1.7b at full width and depth in exact attention
    (``dtype`` compute, fp32 masters) for phase 7's workload, 4 slots of
    LEVER_MAX_LEN positions; on ``mesh`` drawn under ``rules`` (None: the
    default rules, the cache cut by kv head)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import logical_rules_context
    from repro_torch.launch.serve import make_engine

    cfg = dataclasses.replace(get_config("qwen3-1.7b",
                                         attention_mode="exact"),
                              compute_dtype=dtype)
    with (contextlib.nullcontext() if mesh is None or rules is None
          else logical_rules_context(mesh, rules)):
        return make_engine("qwen3-1.7b", cfg=cfg, attention_mode="exact",
                           num_slots=4, max_len=LEVER_MAX_LEN, seed=0,
                           device="cuda", mesh=mesh)


def longest(prompts, n):
    """The ``n`` requests of ``prompts`` with the longest prompts, in id
    order (the same arrays)."""
    keep = sorted(sorted(prompts, key=lambda rid: len(prompts[rid]))[-n:])
    return {rid: prompts[rid] for rid in keep}


def row_gaps(torch, rows, want_rows, tokens, want_tokens, rids):
    """``{request: [relative gap of row i, ...]}`` of two ``serve_rows``
    runs over the rows whose inputs agree: row i (the logits token i is
    sampled from; row 0 the prefill's) up to the row where the two runs'
    tokens part, that row included."""
    out = {}
    for rid in rids:
        want = want_tokens[rid]
        last = parting_points({rid: tokens[rid]}, {rid: want}).get(
            rid, len(want) - 1)
        out[rid] = [rel_err(torch, rows[(rid, i)], want_rows[(rid, i)])
                    for i in range(last + 1)]
    return out


def gap_summary(gaps):
    """``prefill max / decode max over N rows`` of ``row_gaps``' gaps."""
    pre = [g[0] for g in gaps.values()]
    dec = [v for g in gaps.values() for v in g[1:]]
    return (f"prefill {max(pre):.2e}, decode "
            f"{max(dec) if dec else float('nan'):.2e} at most over "
            f"{len(pre) + len(dec)} rows")


def _levers_worker(rank, world, store, out_dir):
    """Phase 33, one rank: (a) kv_seq_shard on (data 1, model 2): qwen3
    SMOKE fp32 tokens; qwen3-1.7b exact bf16 on phase 7's workload
    [tokens, the rows behind them, cache bytes, a decode step's wall and
    device time]; the control, the same with the cache cut by kv head
    (the default rules) on the LEVER_CONTROL_REQUESTS longest requests
    [tokens, rows]; the split-K in fp32 on the LEVER_FP32_REQUESTS
    longest [tokens, rows]; (b) vocab_unsharded: LEVER_STEPS fp32 steps on
    (1, 2) with the vocabulary whole and cut; (c) sp_data: LEVER_STEPS
    fp32 steps at batch 1 on (2, 1) with the rule, one step without (its
    peak)."""
    import torch
    import torch.distributed as dist

    _tp_join(rank, world, store)
    try:
        from repro_torch.distributed import tensor_parallel as tp
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.transformer import init_decode_cache

        out = Path(out_dir)
        given = torch.load(out / "levers_in.pt", weights_only=False)
        model = make_mesh((1, world), ("data", "model"), device_type="cuda")
        data = make_mesh((world, 1), ("data", "model"), device_type="cuda")
        report = {"smoke": smoke_exact_serve(torch, given["small"], model)}
        # a. qwen3-1.7b exact bf16, the cache cut by sequence
        engine = exact_engine(model)
        torch.cuda.reset_peak_memory_stats()
        (done, admissions, steps, wall), rows = serve_rows(
            torch, engine, given["prompts"])
        ex = engine.executor
        base = init_decode_cache(tp.local_config(engine.cfg, world),
                                 ex.local_slots, ex.max_len, "meta")
        layer = ex.cache["layers"][0]
        tokens = torch.zeros((ex.num_slots, 1), dtype=torch.long)
        positions = torch.full((ex.num_slots,), ex.scratch_position,
                               dtype=torch.long)
        busy, _, count, _ = device_profile(
            torch, lambda: ex.decode(tokens, positions))
        report["exact"] = {
            "tokens": {rid: s_.generated for rid, s_ in done.items()},
            "admissions": admissions, "steps": steps, "wall": wall,
            "cache_bytes": sum(t_.numel() * t_.element_size()
                               for t_ in tree_leaves(ex.cache)),
            "base_cache_bytes": sum(t_.numel() * t_.element_size()
                                    for t_ in tree_leaves(base)),
            "k_shape": list(layer["k"].shape),
            "base_k_shape": list(base["layers"][0]["k"].shape),
            "kv_seq": ex.model_cfg.kv_seq, "kv_group": ex.model_cfg.kv_group,
            "decode_ms": decode_step_ms(torch, ex, iters=5),
            "busy_ms": busy,
            "kernels": count,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del engine, ex, layer, done
        gc.collect()
        torch.cuda.empty_cache()
        # a. the control: the cache cut by kv head on the same mesh
        engine = exact_engine(model, rules=None)
        (done, _, _, _), head = serve_rows(torch, engine, given["control"])
        report["head"] = {rid: s_.generated for rid, s_ in done.items()}
        del engine, done
        gc.collect()
        torch.cuda.empty_cache()
        # a. the split-K in fp32 on the longest requests
        engine = exact_engine(model, "float32")
        (done, _, _, _), rows32 = serve_rows(torch, engine, given["long"])
        report["exact32"] = {rid: s_.generated for rid, s_ in done.items()}
        if rank == 0:
            torch.save({"bf16": rows, "head": head, "fp32": rows32},
                       out / "exact_rows.pt")
        del engine, done, rows, head, rows32
        gc.collect()
        torch.cuda.empty_cache()
        # b. the vocabulary whole on every model rank, then cut
        report["vocab"] = [lever_train_run(torch, model, rules, TRAIN_BATCH,
                                           TRAIN_SEQ)
                           for rules in (VOCAB_RULES, None)]
        # c. batch 1 on "data": the sequence cut over it, then not
        report["sp"] = [lever_train_run(torch, data, SP_RULES, 1, SP_SEQ,
                                        depth=SP_DEPTH),
                        lever_train_run(torch, data, None, 1, SP_SEQ, 1,
                                        SP_DEPTH)]
        (out / f"levers{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def levers_phase(torch, np, kernels, prompts):
    """Phase 33 (see the module docstring): the dry run's kv_seq_shard,
    vocab_unsharded and sp_data levers run on the card, 2 gloo processes
    on cuda:0 in one spawn after the one-device runs. Every check is
    fatal."""
    import tempfile

    t_phase = time.perf_counter()
    rng = np.random.default_rng(33)
    small = {rid: rng.integers(0, 512, size=n)
             for rid, n in enumerate((3, 17, 33, 40))}
    control = longest(prompts, LEVER_CONTROL_REQUESTS)
    long = longest(prompts, LEVER_FP32_REQUESTS)
    half = LEVER_MAX_LEN // TP_RANKS
    if min(len(p_) for p_ in long.values()) <= half:
        raise AssertionError(f"33 a: the fp32 requests {list(long)} do not "
                             f"reach rank 1's slots (from {half})")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        torch.save({"prompts": prompts, "small": small, "control": control,
                    "long": long}, out / "levers_in.pt")
        # one device first, each freed before the next and the ranks
        one_small = smoke_exact_serve(torch, small)
        engine = exact_engine()
        (done, _, _, one_wall), one_rows = serve_rows(torch, engine, prompts)
        one_tokens = {rid: s_.generated for rid, s_ in done.items()}
        one_decode_ms = decode_step_ms(torch, engine.executor, iters=5)
        del engine, done
        gc.collect()
        torch.cuda.empty_cache()
        engine = exact_engine(dtype="float32")
        (done, _, _, _), one_rows32 = serve_rows(torch, engine, control)
        one_tokens32 = {rid: s_.generated for rid, s_ in done.items()}
        del engine, done
        gc.collect()
        torch.cuda.empty_cache()
        one_sp = lever_train_run(torch, None, None, 1, SP_SEQ, depth=SP_DEPTH)
        t0 = time.perf_counter()
        spawn_ranks(_levers_worker, TP_RANKS, str(out / "s_levers"), tmp)
        spawn_s = time.perf_counter() - t0
        reps = [json.loads((out / f"levers{r}.json").read_text())
                for r in range(TP_RANKS)]
        rows = torch.load(out / "exact_rows.pt")

    def keyed(tokens):
        return {int(k): v for k, v in tokens.items()}

    # a. kv_seq_shard: SMOKE fp32 tokens bitwise
    smoke = [keyed(rep["smoke"]) for rep in reps]
    print(f"[levers a] kv_seq_shard (rules {KV_RULES}) on (data 1, model "
          f"{TP_RANKS}), {TP_RANKS} gloo processes on cuda:0 ({spawn_s:.1f}s "
          "for all of phase 33's mesh runs with their start-up): qwen3 SMOKE "
          f"exact fp32, greedy tokens of {len(small)} prompts equal one "
          f"device's {smoke[0] == one_small} (rank 1 "
          f"{smoke[1] == one_small})")
    if not smoke[0] == smoke[1] == one_small:
        raise AssertionError(f"33 a: SMOKE split-K tokens {smoke} against "
                             f"one device's {one_small}")
    # a. qwen3-1.7b exact: bf16 against one device, the control and the
    # reading of bf16 itself; fp32 against one device
    ex0 = reps[0]["exact"]
    tok, head = keyed(ex0["tokens"]), keyed(reps[0]["head"])
    tok32 = keyed(reps[0]["exact32"])
    want32 = {rid: one_tokens32[rid] for rid in long}
    vs_one = row_gaps(torch, rows["bf16"], one_rows, tok, one_tokens,
                      prompts)
    head_one = row_gaps(torch, rows["head"], one_rows, head, one_tokens,
                        control)
    reading = row_gaps(torch, one_rows, one_rows32, one_tokens,
                       one_tokens32, control)
    lever = row_gaps(torch, rows["bf16"], rows["head"], tok, head, control)
    fp32 = row_gaps(torch, rows["fp32"], one_rows32, tok32, want32, long)
    limit = max(max(g) for g in reading.values())

    def within(gaps, tol):
        flat = [v for g in gaps.values() for v in g]
        return f"{sum(v <= tol for v in flat)} of {len(flat)}"

    print(f"[levers a] qwen3-1.7b exact, bf16 compute, full width and depth, "
          f"phase 7's workload: {ex0['admissions']} admissions and "
          f"{ex0['steps']} decode steps in {ex0['wall']:.3f}s (one device "
          f"{one_wall:.3f}s); tokens equal one device's {tok == one_tokens},"
          f" part at {parting_points(tok, one_tokens)}; rows against one "
          f"device's (the rows whose inputs agree): {gap_summary(vs_one)}, "
          f"{within(vs_one, BF16_LOGITS_TOL)} within {BF16_LOGITS_TOL:.0e}")
    print(f"[levers a] the control, the cache cut by kv head (the default "
          f"rules) on the same mesh, phase 7's {LEVER_CONTROL_REQUESTS} "
          f"longest requests {list(control)}: tokens part from one device's "
          f"at {parting_points(head, {r: one_tokens[r] for r in control})};"
          f" rows against one device's: {gap_summary(head_one)}, "
          f"{within(head_one, BF16_LOGITS_TOL)} within "
          f"{BF16_LOGITS_TOL:.0e}")
    print(f"[levers a] one device, bf16 against fp32 compute on those "
          f"requests (the reading): tokens part at "
          f"{parting_points({r: one_tokens[r] for r in control}, one_tokens32)}"
          f"; rows {gap_summary(reading)}, "
          f"{within(reading, BF16_LOGITS_TOL)} within "
          f"{BF16_LOGITS_TOL:.0e}; the limit below {limit:.2e}")
    print(f"[levers a] split-K against the control (bf16, the same mesh and "
          f"requests): tokens part at {parting_points(tok, head)}; rows "
          f"{gap_summary(lever)} (limit {limit:.2e}: one device's bf16 "
          f"against fp32), {within(lever, BF16_LOGITS_TOL)} within "
          f"{BF16_LOGITS_TOL:.0e}; by request "
          + ", ".join(f"{rid}: {max(g):.2e}" for rid, g in lever.items()))
    crossing = sum(len(long[rid]) + i - 1 >= half
                   for rid in long for i in range(1, len(want32[rid])))
    print(f"[levers a] the split-K in fp32 compute on phase 7's "
          f"{LEVER_FP32_REQUESTS} longest requests "
          + ", ".join(f"{rid} ({len(p_)} tokens)" for rid, p_ in long.items())
          + f": tokens equal one device's {tok32 == want32} (rank 1 "
          f"{keyed(reps[1]['exact32']) == want32}), part at "
          f"{parting_points(tok32, want32)}; rows against one device's "
          f"{gap_summary(fp32)} (budget {E2E_TOL:.0e}); {crossing} decode "
          f"steps read rank 1's slots (positions from {half})")
    for r, rep in enumerate(reps):
        e = rep["exact"]
        print(f"[levers a] rank {r}: kv_seq {e['kv_seq']}, kv_group "
              f"{e['kv_group']}; a layer's k {e['k_shape']} (head-cut "
              f"baseline {e['base_k_shape']}); cache {e['cache_bytes']} "
              f"bytes (baseline {e['base_cache_bytes']}, the shapes' bytes);"
              f" a decode step (4 lanes) {e['decode_ms']:.2f} ms wall "
              f"(median of 5; one device {one_decode_ms:.2f}), "
              f"{e['busy_ms']:.3f} ms device busy over {e['kernels']} "
              f"kernels (one profiled step); peak {e['peak_gib']:.2f} GiB")
    size = ex0["base_k_shape"][1]
    finite = all(math.isfinite(v)
                 for gaps in (vs_one, head_one, reading, lever, fp32)
                 for g in gaps.values() for v in g)
    if not (reps[1]["exact"]["tokens"] == ex0["tokens"]
            and reps[1]["head"] == reps[0]["head"]
            and all(rep["exact"]["kv_seq"] and rep["exact"]["k_shape"][1]
                    == size // TP_RANKS for rep in reps)
            and finite and max(max(g) for g in lever.values()) <= limit
            and keyed(reps[1]["exact32"]) == tok32 == want32
            and max(max(g) for g in fp32.values()) <= E2E_TOL):
        raise AssertionError("33 a: qwen3-1.7b split-K decode failed")
    # b. vocab_unsharded: the same run with the vocabulary cut
    whole, cut = reps[0]["vocab"]
    vgaps = [abs(a - b) / abs(b) for a, b in zip(whole["losses"],
                                                 cut["losses"])]
    ngaps = [abs(a - b) / abs(b) for a, b in zip(whole["grad_norms"],
                                                 cut["grad_norms"])]
    print(f"[levers b] vocab_unsharded (rules {VOCAB_RULES}): qwen3-1.7b rm "
          f"fp32, {TRAIN_DEPTH} layers, {LEVER_STEPS} steps of {TRAIN_BATCH}"
          f" x {TRAIN_SEQ} tokens on (1, {TP_RANKS}): losses "
          + " ".join(f"{v:.7f}" for v in whole["losses"]) + " against "
          + " ".join(f"{v:.7f}" for v in cut["losses"]) + " with it cut; "
          "gaps " + " ".join(f"{v:.2e}" for v in vgaps) + f" (budget "
          f"{LEVER_LOSS_TOL:.0e}); grad_norm gaps "
          + " ".join(f"{v:.2e}" for v in ngaps) + "; B2 a step a rank "
          f"{whole['b2']} (want {whole['want_b2']}); peak a rank "
          + " / ".join(f"{rep['vocab'][0]['peak_gib']:.2f}" for rep in reps)
          + f" GiB whole, {cut['peak_gib']:.2f} cut; step walls "
          + " / ".join(f"{v:.0f}" for v in whole["step_ms"]) + " ms whole, "
          + " / ".join(f"{v:.0f}" for v in cut["step_ms"]) + " cut")
    if not (max(vgaps) <= LEVER_LOSS_TOL
            and reps[1]["vocab"][0]["losses"] == whole["losses"]
            and all(rep["vocab"][0]["b2"] == [whole["want_b2"]] * LEVER_STEPS
                    for rep in reps)):
        raise AssertionError("33 b: vocab_unsharded training failed")
    # c. sp_data: batch 1 on (2, 1) against one device
    on, off = reps[0]["sp"]
    sgaps = [abs(a - b) / abs(b) for a, b in zip(on["losses"],
                                                 one_sp["losses"])]
    sngaps = [abs(a - b) / abs(b) for a, b in zip(on["grad_norms"],
                                                  one_sp["grad_norms"])]
    print(f"[levers c] sp_data (rules {SP_RULES}): qwen3-1.7b rm fp32, "
          f"{SP_DEPTH} layers, {LEVER_STEPS} steps of 1 x {SP_SEQ} tokens "
          f"on (data {TP_RANKS}, model 1): losses "
          + " ".join(f"{v:.6f}" for v in on["losses"]) + " against one "
          "device's " + " ".join(f"{v:.6f}" for v in one_sp["losses"])
          + "; gaps " + " ".join(f"{v:.2e}" for v in sgaps) + "; grad_norm "
          "gaps " + " ".join(f"{v:.2e}" for v in sngaps)
          + f" (budget {TP_FP32_TOL:.0e}); peak a rank "
          + " / ".join(f"{rep['sp'][0]['peak_gib']:.2f}" for rep in reps)
          + " GiB with the rule, "
          + " / ".join(f"{rep['sp'][1]['peak_gib']:.2f}" for rep in reps)
          + f" without (one device {one_sp['peak_gib']:.2f}); step walls "
          + " / ".join(f"{v:.0f}" for v in on["step_ms"]) + " ms with, "
          + " / ".join(f"{v:.0f}" for v in off["step_ms"])
          + " without (one step, for its peak)")
    if not (max(sgaps + sngaps) <= TP_FP32_TOL
            and reps[1]["sp"][0]["losses"] == on["losses"]):
        raise AssertionError("33 c: sp_data training failed")
    kernels["B2"]["vocab_unsharded_train_launches_per_rank_step"] = \
        whole["b2"][0]
    kernels["B2"]["sp_data_train_launches_per_rank_step"] = on["b2"][0]
    kernels["B2"]["sp_data_train_peak_gib_per_rank"] = max(
        rep["sp"][0]["peak_gib"] for rep in reps)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[levers] phase 33 in {time.perf_counter() - t_phase:.2f}s")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    t_main = time.perf_counter()
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import registry
    from repro_torch.core.plan import init_omegas, pack_omegas, plan_columns
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import bucket_schedule, sketch_schedule
    from repro_torch.kernels.rm_attention.ops import (
        rm_attention_chunked,
        rm_fused_apply,
        rm_fused_causal,
        rm_fused_state,
    )
    from repro_torch.kernels.rm_attention.ref import rm_fused_causal_ref
    from repro_torch.ctr.plan import init_ctr_params, pack_ctr
    from repro_torch.ctr.ref import ctr_feature_fused_ref
    from repro_torch.kernels.ctr_feature.ops import ctr_feature_fused
    from repro_torch.kernels.rm_feature.ops import (
        apply_feature_map_bucketed,
        rm_feature_bucket,
        rm_feature_fused,
    )
    from repro_torch.kernels.rm_feature.ref import (
        rm_feature_bucket_ref,
        rm_feature_fused_ref,
    )
    from repro_torch.kernels.structured_feature.ops import (
        structured_feature_fused,
    )
    from repro_torch.kernels.tensor_sketch.ops import tensor_sketch_fused
    from repro_torch.launch.serve import make_engine
    from repro_torch.models.attention import rm_plan_for
    from repro_torch.serve import Request
    from repro_torch.sketch.plan import init_sketch_params, pack_sketch
    from repro_torch.sketch.ref import tensor_sketch_fused_ref
    from repro_torch.structured.plan import (
        init_structured_params,
        pack_structured,
    )
    from repro_torch.structured.ref import structured_feature_fused_ref

    # -- 1. environment and build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {len(_build.LIBRARIES)} kernels ready in "
          f"{time.perf_counter() - t0:.2f}s")
    for name, (secs, log) in _build.build_report().items():
        report = [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {secs:.2f}s; " + " | ".join(report))

    cfg = get_config("qwen3-1.7b", attention_mode="rm")
    dh = cfg.resolved_head_dim
    plan = rm_plan_for(cfg, dh)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    w32 = pack_omegas(plan, init_omegas(plan, gen))
    col_deg, col_scale = plan_columns(plan, "cuda")
    deg_np = plan.column_degrees()
    f = w32.shape[1]
    print(f"[plan] qwen3-1.7b rm head: packed w {tuple(w32.shape)}, "
          f"F={f} columns, degrees {np.bincount(deg_np).tolist()}")
    kernels = {}
    print(f"[clock] SM clock after a 1 s warm-up: {warm_card(torch)}")

    # -- 2. B1 against its plain version ------------------------------------
    from repro_torch.core import PolynomialKernel, make_feature_map
    from repro_torch.kernels.common import causal_schedule, pick_feature_tiles

    report_build(torch, "B1", "rm_feature")
    report_build(torch, "B2", "rm_fused_attention")
    decode_rows = 2 * 4 * cfg.num_heads          # stacked q+k, 4 slots
    # the adult-shaped map that phase 23 featurizes (poly10, d 123, D 4000)
    fm_b1 = make_feature_map(PolynomialKernel(10, 1.0), 123, 4000, seed=0)
    wa32 = pack_omegas(fm_b1.plan, fm_b1.omegas)
    cda, csa = plan_columns(fm_b1.plan, "cuda")
    cda_np = fm_b1.plan.column_degrees()
    b1_checks = []
    for rows, label, wt32, c_deg, c_scale, c_np, iters in (
            (decode_rows, "decode", w32, col_deg, col_scale, deg_np, 50),
            (4096, "gram", w32, col_deg, col_scale, deg_np, 20),
            (20000, "adult", wa32, cda, csa, cda_np, 5)):
        d_in, f_out = wt32.shape[2], wt32.shape[1]
        for dtype in (torch.float32, torch.bfloat16):
            x = unit_rows(torch, (rows, d_in), gen).to(dtype)
            w = wt32.to(dtype)
            got = rm_feature_fused(x, w, c_deg, c_scale)
            want = rm_feature_fused_ref(x, w, c_deg, c_scale)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = B1_TOL * max(1.0, want.abs().max().item())
            del got, want
            ms = time_ms(torch, lambda: rm_feature_fused(x, w, c_deg,
                                                          c_scale),
                         iters=iters)
            dev_ms = kernel_device_ms(torch, lambda: rm_feature_fused(
                x, w, c_deg, c_scale), "rm_feature_kernel", iters=iters)
            plain_ms = time_ms(torch, lambda: rm_feature_fused_ref(
                x, w, c_deg, c_scale), iters=min(iters, 10))
            dname = str(dtype).split(".")[-1]
            item = x.element_size()
            nbytes = (rows * d_in * item + omega_bytes(c_np, d_in, item)
                      + f_out * 8 + rows * f_out * 4)
            ops = featurize_ops(rows, c_np, d_in)
            bms, by = bound(nbytes, ops, dname)
            tcms, tcby = tensor_core_bound(nbytes, ops, 0, dname, True)
            row_tile, ctw = pick_feature_tiles(rows, f_out, d_in, item)
            n_ct = -(-f_out // 8)
            grid = -(-rows // row_tile) * -(-n_ct // (4 * ctw))
            print(f"[B1] {label} x[{rows},{d_in}] F {f_out} {dname}: "
                  f"max_abs_err {err:.3e} (tol {tol:.1e}) kernel "
                  f"{dev_ms:.4f} ms device (profiler), {ms:.4f} ms events; "
                  f"plain {plain_ms:.4f} ms; bound {tcms:.6f} ms ({tcby}, "
                  f"tensor cores) / {bms:.6f} ms ({by}, CUDA cores); grid "
                  f"{grid} blocks of 4 warps ("
                  + ("chain kernel, 16 rows" if row_tile == 16 else
                     "tile kernel, 64 rows") + f" a block, {ctw} column "
                  "tile(s) a warp)")
            if not (err <= tol):
                raise AssertionError(f"B1 {label} {dname}: error {err} > "
                                     f"{tol}")
            b1_checks.append((f"{label} {dname}", err, tol))
            if dtype == torch.float32 and label == "decode":
                hus = host_us(torch, lambda: rm_feature_fused(
                    x, w, c_deg, c_scale))
                print(f"[B1] decode host time {hus:.1f} us a call")
                kernels["B1"] = dict(
                    name="rm_feature_fused", route="cuda",
                    source="src/repro_torch/csrc/rm_feature.cu",
                    replaces="src/repro/kernels/rm_feature/rm_feature.py:79",
                    shape=f"x[{rows},{dh}] fp32 x w{tuple(w32.shape)}",
                    ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                    bound_ms=tcms, bound_by=tcby, library_ms=None,
                    bound_cuda_core_ms=bms, grid=grid)
            elif dtype == torch.float32:
                kernels["B1"].update({
                    f"{label}_shape": f"x[{rows},{d_in}] fp32, F {f_out}",
                    f"{label}_ms": ms, f"{label}_device_ms": dev_ms,
                    f"{label}_plain_ms": plain_ms,
                    f"{label}_bound_ms": tcms, f"{label}_grid": grid})
            del x, w
    del wa32, fm_b1
    torch.cuda.empty_cache()

    # -- 3. B2 against its plain version ------------------------------------
    # the prefill shape (a bucket-256 prompt's 16 heads), a 4096-token
    # prompt, a wide feature axis (qwen3's head at a budget of 3400: F
    # above 2048), and a 32768-token prompt (qwen3's longest context), with
    # the device memory a call takes beside its inputs
    from repro_torch.core.maclaurin import ExponentialDotProductKernel
    from repro_torch.core.plan import make_feature_plan

    wide_plan = make_feature_plan(ExponentialDotProductKernel(1.0), dh, 3400,
                                  measure="proportional", n_max=8)
    ww32 = pack_omegas(wide_plan, init_omegas(wide_plan, gen))
    wcd, wcs = plan_columns(wide_plan, "cuda")
    b2_checks = []
    for label, t, pad, wt32, c_deg, c_scale, c_np, dtypes, iters in (
            ("prefill", 256, 56, w32, col_deg, col_scale, deg_np,
             (torch.float32, torch.bfloat16), 20),
            ("long", 4096, 100, w32, col_deg, col_scale, deg_np,
             (torch.float32, torch.bfloat16), 10),
            ("wide", 256, 56, ww32, wcd, wcs, wide_plan.column_degrees(),
             (torch.float32,), 10),
            ("prompt32k", 32768, 100, w32, col_deg, col_scale, deg_np,
             (torch.float32,), 3)):
        bh, f_b2 = cfg.num_heads, wt32.shape[1]
        for dtype in dtypes:
            q = unit_rows(torch, (1, bh, t, dh), gen).to(dtype)
            k = unit_rows(torch, (1, bh, t, dh), gen).to(dtype)
            v = torch.randn((1, bh, t, dh), generator=gen, device="cuda")
            kvalid = torch.ones((1, t), device="cuda")
            kvalid[0, t - pad:] = 0.0              # a padded prompt bucket
            w = wt32.to(dtype)
            args = (q, k, v, kvalid, w, c_deg, c_scale)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = rm_fused_causal(*args, cfg.rm.eps)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            sched = rm_fused_causal.last_schedule
            # the outputs and the scratch of at most 32 chunk states
            out_bytes = 4 * bh * (t * dh + f_b2 * (dh + 1))
            if peak > out_bytes + sched.scratch_bytes + 2**20:
                raise AssertionError(
                    f"B2 {label}: a call took {peak} bytes beside its "
                    f"inputs, more than its outputs ({out_bytes}) and "
                    f"scratch ({sched.scratch_bytes})")
            again = rm_fused_causal(*args, cfg.rm.eps)
            want = rm_fused_causal_ref(*args, chunk=cfg.rm.chunk,
                                       eps=cfg.rm.eps)
            torch.cuda.synchronize()
            dname = str(dtype).split(".")[-1]
            if not all(torch.equal(g_, a_) for g_, a_ in zip(got, again)):
                raise AssertionError(f"B2 {label} {dname}: two calls differ")
            errs, tols = [], []
            for name, g_, w_ in zip(("out", "S", "n"), got, want):
                scale_ = max(1.0, w_.abs().max().item())
                errs.append((g_ - w_).abs().max().item())
                tols.append(B2_TOL * scale_)
                b2_checks.append((f"{name} {label} {dname}", errs[-1],
                                  tols[-1]))
                if not (errs[-1] <= tols[-1] and torch.isfinite(g_).all()):
                    raise AssertionError(f"B2 {name} {label} {dname}: error "
                                         f"{errs[-1]} > {tols[-1]}")
                # fp32 inputs: the precision of 3xTF32
                if dtype == torch.float32 and \
                        not errs[-1] <= B2_FP32_TOL * scale_:
                    raise AssertionError(
                        f"B2 {name} {label} fp32: error "
                        f"{errs[-1] / scale_:.2e} x max(1, max |plain|) > "
                        f"{B2_FP32_TOL}: not 3xTF32-accurate")
            del got, again, want
            ms = time_ms(torch, lambda: rm_fused_causal(*args, cfg.rm.eps),
                         iters=iters)
            dev_ms = kernel_device_ms(
                torch, lambda: rm_fused_causal(*args, cfg.rm.eps),
                "chunk_", iters=iters)
            plain_ms = time_ms(torch, lambda: rm_fused_causal_ref(
                *args, chunk=cfg.rm.chunk, eps=cfg.rm.eps),
                iters=min(iters, 10))
            item = q.element_size()
            valid = bh * (t - pad)
            nbytes = (2 * bh * t * dh * item + bh * t * dh * 4 + t * 4
                      + omega_bytes(c_np, dh, item) + f_b2 * 8
                      + bh * t * dh * 4 + bh * f_b2 * dh * 4 + bh * f_b2 * 4)
            # featurize q rows and the real k rows, then the recurrent form:
            # S += zk v^T, n += zk, num = zq S, den = zq n, divide
            feat_ops = (featurize_ops(bh * t, c_np, dh)
                        + featurize_ops(valid, c_np, dh))
            other_ops = bh * t * (4 * f_b2 * dh + 3 * f_b2 + dh)
            bms, by = bound(nbytes, feat_ops + other_ops, dname)
            tcms, tcby = tensor_core_bound(nbytes, feat_ops, other_ops,
                                           dname, True)
            print(f"[B2] {label} q,k[{bh},{t},{dh}] F {f_b2} ({pad} keys "
                  f"padded) {dname}: max_abs_err out/S/n {errs[0]:.3e}/"
                  f"{errs[1]:.3e}/{errs[2]:.3e} (tol {tols[0]:.1e}/"
                  f"{tols[1]:.1e}/{tols[2]:.1e}"
                  + (f"; 3xTF32 gate {B2_FP32_TOL:.0e}" if
                     dtype == torch.float32 else "")
                  + f"), two calls bitwise equal; kernel {dev_ms:.4f} ms "
                  f"device (profiler, three kernels), {ms:.4f} ms events; "
                  f"plain {plain_ms:.4f} ms; bound {tcms:.5f} ms ({tcby}, "
                  f"tensor cores) / {bms:.5f} ms ({by}, CUDA cores); grid "
                  f"pass A {sched.blocks_a} + pass B {sched.blocks_b} "
                  f"blocks ({sched.n_chunks} chunks in segments of "
                  f"{sched.seg_chunks}, {sched.n_agroups} feature groups, "
                  f"{sched.n_dvbgroups} value groups); device memory of a "
                  f"call beside its inputs {peak / 2**20:.1f} MiB (outputs "
                  f"{out_bytes / 2**20:.1f} MiB, scratch "
                  f"{sched.scratch_bytes / 2**20:.1f} MiB)")
            if dtype == torch.float32 and label == "prefill":
                hus = host_us(torch, lambda: rm_fused_causal(*args,
                                                             cfg.rm.eps),
                              iters=50)
                print(f"[B2] host time {hus:.1f} us a call")
                kernels["B2"] = dict(
                    name="rm_fused_causal", route="cuda",
                    source="src/repro_torch/csrc/rm_fused_attention.cu",
                    replaces="src/repro/kernels/rm_attention/fused.py:191",
                    shape=f"q,k[{bh},{t},{dh}] fp32, F={f_b2}",
                    ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                    bound_ms=tcms, bound_by=tcby, library_ms=None,
                    bound_cuda_core_ms=bms,
                    grid=sched.blocks_a + sched.blocks_b)
            elif dtype == torch.float32:
                kernels["B2"].update({
                    f"{label}_shape": f"q,k[{bh},{t},{dh}] fp32, F={f_b2}",
                    f"{label}_ms": ms, f"{label}_device_ms": dev_ms,
                    f"{label}_plain_ms": plain_ms,
                    f"{label}_bound_ms": tcms,
                    f"{label}_grid": sched.blocks_a + sched.blocks_b})
            if dtype == torch.float32:
                kernels["B2"][f"{label}_peak_mib"] = peak / 2**20
            del q, k, v, args
            torch.cuda.empty_cache()
    del ww32

    # -- 4. B6 against its plain version ------------------------------------
    ts_cfg = get_config("qwen3-1.7b", attention_mode="rm",
                        estimator="tensor_sketch")
    ts_plan = rm_plan_for(ts_cfg, dh)
    ts_entry = registry.get("tensor_sketch")
    ts_params = init_sketch_params(ts_plan, gen)
    packed32 = pack_sketch(ts_plan, ts_params)
    ts_deg, ts_scale = plan_columns(ts_plan, "cuda")
    starts = ts_plan.block_starts()
    fs = ts_plan.num_sketch_cols
    print(f"[plan] qwen3-1.7b tensor_sketch head: degrees "
          f"{ts_plan.degrees} widths {ts_plan.counts}, wr/wi "
          f"{tuple(packed32[0].shape)}, mr/mi {tuple(packed32[2].shape)}, "
          f"F={ts_plan.output_dim} features")
    # every row count the slice gives B6: q (or k) of 4 decode slots, and
    # one prompt's q (or k) at each prefill bucket; together they take
    # every output group that sketch_schedule chooses on the path
    report_build(torch, "B6", "tensor_sketch")
    b6_shapes = [(4 * cfg.num_heads, "decode")] + [
        (bucket * cfg.num_heads, f"prefill bucket {bucket}")
        for bucket in (32, 64, 128, 256)]
    b6_checks = []
    for rows, label in b6_shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = unit_rows(torch, (rows, dh), gen).to(dtype)
            wr, wi, mr, mi = (p_.to(dtype) for p_ in packed32)
            args = (x, wr, wi, ts_deg, mr, mi, ts_scale)
            got = tensor_sketch_fused(*args, starts)
            again = tensor_sketch_fused(*args, starts)
            want = tensor_sketch_fused_ref(*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = B6_TOL * max(1.0, want.abs().max().item())
            bitwise = torch.equal(got, again)
            dev_ms = kernel_device_ms(torch, lambda: tensor_sketch_fused(
                *args, starts), "tensor_sketch_kernel")
            ms = time_ms(torch, lambda: tensor_sketch_fused(*args, starts))
            plain_ms = time_ms(torch, lambda: tensor_sketch_fused_ref(*args))
            dname = str(dtype).split(".")[-1]
            nbytes, ops1, ops2 = sketch_cost(rows, ts_plan, x.element_size())
            bms, by = bound(nbytes, ops1 + ops2, dname)
            tcms, tcby = tensor_core_bound(nbytes, ops1, ops2, dname, False)
            sched = sketch_schedule(starts, rows, dh)
            grid = -(-rows // 16) * sched.n_items
            print(f"[B6] {label} x[{rows},{dh}] {dname}: max_abs_err "
                  f"{err:.3e} (tol {tol:.1e}), two calls bitwise equal "
                  f"{bitwise}; kernel {dev_ms:.4f} ms device (profiler), "
                  f"{ms:.4f} ms events; plain {plain_ms:.4f} ms; bound "
                  f"{tcms:.6f} ms ({tcby}, tensor cores) / {bms:.6f} ms "
                  f"({by}, CUDA cores); grid {grid} blocks of 8 warps (16 "
                  f"rows x {sched.n_items} items, groups of {sched.group} "
                  "columns)")
            if not (err <= tol and bitwise):
                raise AssertionError(f"B6 {label} {dname}: error {err} > "
                                     f"{tol} or two calls differ")
            b6_checks.append((f"{label} {dname}", err, tol))
            if label == "decode" and dtype == torch.float32:
                hus = host_us(torch, lambda: tensor_sketch_fused(*args,
                                                                 starts))
                xs32 = x.reshape(4, cfg.num_heads, 1, dh)
                apply_us = host_us(torch, lambda: ts_entry.apply(
                    ts_plan, ts_params, xs32, packed=packed32))
                print(f"[B6] decode host time {hus:.1f} us a call; the "
                      f"whole featurize (registry apply) {apply_us:.1f} us")
                kernels["B6"] = dict(
                    name="tensor_sketch_fused", route="cuda",
                    source="src/repro_torch/csrc/tensor_sketch.cu",
                    replaces="src/repro/kernels/tensor_sketch/"
                             "tensor_sketch.py:92",
                    shape=f"x[{rows},{dh}] fp32 x wr,wi"
                          f"{tuple(packed32[0].shape)}, blocks {starts}",
                    ms=dev_ms, events_ms=ms, plain_ms=plain_ms,
                    bound_ms=tcms, bound_by=tcby, library_ms=None,
                    bound_cuda_core_ms=bms, grid=grid, host_us=hus)
            elif dtype == torch.float32 and rows == 4096:
                kernels["B6"].update(
                    prefill_shape=f"x[{rows},{dh}] fp32",
                    prefill_ms=dev_ms, prefill_events_ms=ms,
                    prefill_plain_ms=plain_ms, prefill_bound_ms=tcms,
                    prefill_bound_cuda_core_ms=bms, prefill_grid=grid)
            del x, args, got, again, want
    # the paper's width, which the earlier kernel refused: the exp map at
    # d 50, D 4000 through make_feature_map (a 2000-column degree block),
    # its Gram on the card against the same map's on the CPU
    from repro_torch.core import ExponentialDotProductKernel

    fm_ts = make_feature_map(ExponentialDotProductKernel(), 50, 4000,
                             estimator="tensor_sketch", seed=0)
    fm_ts_cpu = type(fm_ts)(plan=fm_ts.plan, params={
        k_: v_.cpu() for k_, v_ in fm_ts.params.items()})
    x_exp = unit_rows(torch, (100, 50), gen)
    before = tensor_sketch_fused.launches
    k_card = fm_ts.estimate_gram(x_exp)
    torch.cuda.synchronize()
    if tensor_sketch_fused.launches != before + 1:
        raise AssertionError("the D 4000 map did not launch B6 once")
    k_cpu = fm_ts_cpu.estimate_gram(x_exp.cpu())
    err = (k_card.cpu() - k_cpu).abs().max().item()
    tol = B6_GRAM_TOL * max(1.0, k_cpu.abs().max().item())
    starts_exp = fm_ts.plan.block_starts()
    sched = sketch_schedule(starts_exp, 100, 50)
    dev_ms = kernel_device_ms(torch, lambda: fm_ts.apply(x_exp),
                              "tensor_sketch_kernel", iters=10)
    nbytes, ops1, ops2 = sketch_cost(100, fm_ts.plan, 4)
    tcms, tcby = tensor_core_bound(nbytes, ops1, ops2, "float32", False)
    print(f"[B6] exp map d 50 D 4000 (make_feature_map, {len(starts_exp) - 1}"
          f" degree blocks, widest {max(fm_ts.plan.counts)} columns), Gram "
          f"of X[100,50] card vs CPU: max_abs_err {err:.3e} (tol {tol:.1e}); "
          f"kernel {dev_ms:.4f} ms device, bound {tcms:.6f} ms ({tcby}, "
          f"tensor cores), {sched.n_items} items of {sched.group} columns")
    if not (err <= tol and torch.isfinite(k_card).all()):
        raise AssertionError(f"B6 D 4000 Gram: error {err} > {tol}")
    b6_checks.append(("exp D 4000 gram", err, tol))
    kernels["B6"].update(d4000_shape="exp d 50 D 4000, x[100,50] fp32",
                         d4000_ms=dev_ms, d4000_bound_ms=tcms)
    del fm_ts, fm_ts_cpu, k_card, k_cpu
    # the Gram entry point: estimate_gram over the family's apply, with the
    # kernel on the card against the plain version on the CPU
    xg = unit_rows(torch, (4096, dh), gen)
    cpu_params = {k_: v_.cpu() for k_, v_ in ts_params.items()}
    for prec in ("fp32", "bf16"):
        before = tensor_sketch_fused.launches
        g_card = registry.estimate_gram(
            lambda a: ts_entry.apply(ts_plan, ts_params, a, precision=prec),
            xg)
        torch.cuda.synchronize()
        if tensor_sketch_fused.launches != before + 1:
            raise AssertionError("estimate_gram did not launch B6 once")
        g_plain = registry.estimate_gram(
            lambda a: ts_entry.apply(ts_plan, cpu_params, a, precision=prec),
            xg.cpu())
        err = (g_card.cpu() - g_plain).abs().max().item()
        tol = B6_GRAM_TOL * max(1.0, g_plain.abs().max().item())
        print(f"[B6] estimate_gram X[4096,{dh}] {prec}: max_abs_err "
              f"{err:.3e} (tol {tol:.1e}), Gram {tuple(g_card.shape)}")
        if not (err <= tol and torch.isfinite(g_card).all()):
            raise AssertionError(f"B6 Gram {prec}: error {err} > {tol}")
        b6_checks.append((f"gram {prec}", err, tol))

    # -- 5. B5 against its plain version ------------------------------------
    report_build(torch, "B5", "rm_attention_chunked")
    b5_checks = []
    for t, chunk, padded in ((256, cfg.rm.chunk, 200), (32, 32, None)):
        bh = cfg.num_heads
        xq = unit_rows(torch, (bh * t, dh), gen)
        xk = unit_rows(torch, (bh * t, dh), gen)
        zq = ts_entry.apply(ts_plan, ts_params, xq).reshape(1, bh, t, -1)
        zk = ts_entry.apply(ts_plan, ts_params, xk).reshape(1, bh, t, -1)
        if padded:                  # keys of the second half padded
            kvalid = torch.ones((bh, t), device="cuda")
            kvalid[bh // 2:, padded:] = 0.0
            zk = zk * kvalid[None, :, :, None]
        v = torch.randn((1, bh, t, dh), generator=gen, device="cuda")
        b5_checks += b5_check(torch, f"T{t}", zq, zk, v, chunk, cfg.rm.eps,
                              kernels, t == 256)
    # each kernel's line reports the check nearest its limit, with that
    # check's own error and limit
    for kid, checks in (("B1", b1_checks), ("B2", b2_checks),
                        ("B6", b6_checks), ("B5", b5_checks)):
        label, err, tol = worst(checks)
        kernels[kid].update(max_abs_err=err, tol=tol, check=label)

    # -- 6. small end-to-end references -------------------------------------
    from repro_torch.models import transformer as tt
    from repro_torch.serve import Scheduler

    def to_cuda(p, device="cuda"):
        if isinstance(p, dict):
            return {key: to_cuda(val, device) for key, val in p.items()}
        if isinstance(p, list):
            return [to_cuda(val, device) for val in p]
        return p.to(device)

    small_rm = None
    for est in ("rm", "tensor_sketch"):
        small = dataclasses.replace(
            get_config("qwen3-1.7b", smoke=True, attention_mode="rm",
                       estimator=est), compute_dtype="float32")
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, small.vocab_size, size=(2, 40)))
        cpu_params = tt.init_model(small, torch.Generator().manual_seed(0))
        with torch.inference_mode():
            ref_logits, _ = tt.forward(cpu_params, small, {"tokens": toks})
            gpu_logits, _ = tt.forward(to_cuda(cpu_params), small,
                                       {"tokens": toks.cuda()})
        rel = rel_err(torch, gpu_logits, ref_logits)
        small_tokens = {}
        for dev, params in (("cpu", cpu_params),
                            ("cuda", to_cuda(cpu_params))):
            sched = Scheduler(small, params, num_slots=2, max_len=64,
                              device=dev)
            for rid, n in enumerate((5, 20, 37)):
                sched.submit(Request(rid, np.random.default_rng(
                    rid).integers(0, small.vocab_size, size=n),
                    max_new_tokens=8))
            small_tokens[dev] = {r: s.generated
                                 for r, s in sched.run().items()}
        same = small_tokens["cpu"] == small_tokens["cuda"]
        print(f"[small] qwen3 SMOKE fp32 {est}, card vs CPU: forward logits "
              f"rel err {rel:.2e} (tol {E2E_TOL:.0e}), greedy tokens "
              f"identical: {same}")
        if not (rel <= E2E_TOL and same
                and torch.isfinite(gpu_logits).all()):
            raise AssertionError(f"small {est} end-to-end check failed")
        if est == "rm":
            small_rm = (small, to_cuda(cpu_params))
    small, params = small_rm
    off = dataclasses.replace(small, rm=dataclasses.replace(
        small.rm, fuse_featurize="off"))
    with torch.inference_mode():
        fused_logits, _ = tt.forward(params, small, {"tokens": toks.cuda()})
        before = (rm_feature_fused.launches, rm_attention_chunked.launches)
        off_logits, _ = tt.forward(params, off, {"tokens": toks.cuda()})
        torch.cuda.synchronize()
    ran = (rm_feature_fused.launches - before[0],
           rm_attention_chunked.launches - before[1])
    rel = rel_err(torch, off_logits, fused_logits)
    print(f"[small] qwen3 SMOKE fp32 rm on the card, two-launch (B1 + B5: "
          f"{ran[0]} + {ran[1]} launches) vs fused (B2): logits rel err "
          f"{rel:.2e} (tol {E2E_TOL:.0e})")
    if not (rel <= E2E_TOL and ran == (2 * small.num_layers,
                                       small.num_layers)):
        raise AssertionError("rm two-launch vs fused check failed")
    del small_rm, params

    # -- 7. the rm slice at full width and depth ----------------------------
    print(f"[slice] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} kv, "
          f"head_dim {dh}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          "attention_mode rm; depth cut: none")
    t0 = time.perf_counter()
    engine = make_engine("qwen3-1.7b", smoke=False, attention_mode="rm",
                         num_slots=4, max_len=256, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[slice] weights + engine ready in {time.perf_counter() - t0:.2f}s")
    rng = np.random.default_rng(0)
    lengths = (5, 17, 30, 45, 64, 90, 130, 200)  # buckets 32..256
    prompts = {rid: rng.integers(0, cfg.vocab_size, size=n)
               for rid, n in enumerate(lengths)}
    layers = cfg.num_layers
    all_counters = {"B1": rm_feature_fused, "B2": rm_fused_causal,
                    "B5": rm_attention_chunked, "B6": tensor_sketch_fused,
                    "B7": ctr_feature_fused, "B8": structured_feature_fused,
                    "B9": rm_feature_bucket}
    done, launches = serve_slice(
        torch, "slice", engine, cfg, prompts, all_counters,
        lambda adm, steps: {"B1": steps * layers, "B2": adm * layers,
                            "B5": 0, "B6": 0, "B7": 0, "B8": 0, "B9": 0})
    kernels["B1"]["launches"] = launches["B1"]
    kernels["B2"]["launches"] = launches["B2"]
    rm_tokens = {rid: s_.generated for rid, s_ in done.items()}

    # -- 8. where the rm slice's time goes (warm) ---------------------------
    shares = where_time_goes(
        torch, "rm", engine, prompts, done,
        families={"B1": ("rm_feature_kernel",), "B2": ("chunk_",)})
    kernels["B1"]["decode_step_device_ms"] = shares["decode step"]["B1"]
    kernels["B2"]["prefill_256_device_ms"] = \
        shares["prefill bucket 256"]["B2"]
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # -- 9. the tensor_sketch slice -----------------------------------------
    print(f"[ts slice] {ts_cfg.name}: the same model with estimator "
          f"tensor_sketch (F={ts_plan.output_dim} features, two-launch "
          "attention); depth cut: none")
    t0 = time.perf_counter()
    engine = make_engine("qwen3-1.7b", smoke=False, attention_mode="rm",
                         estimator="tensor_sketch", num_slots=4,
                         max_len=256, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[ts slice] weights + engine ready in "
          f"{time.perf_counter() - t0:.2f}s; estimator {engine.estimator}, "
          f"fused attention {engine.fused_attention}")
    if engine.estimator != "tensor_sketch" or engine.fused_attention:
        raise AssertionError("the tensor_sketch engine is not on the "
                             "two-launch path")
    done, launches = serve_slice(
        torch, "ts slice", engine, ts_cfg, prompts, all_counters,
        lambda adm, steps: {"B1": 0, "B2": 0, "B5": adm * layers,
                            "B6": 2 * layers * (adm + steps), "B7": 0,
                            "B8": 0, "B9": 0})
    kernels["B5"]["launches"] = launches["B5"]
    kernels["B6"]["launches"] = launches["B6"]

    # -- 10. where the tensor_sketch slice's time goes (warm) ---------------
    shares = where_time_goes(
        torch, "ts", engine, prompts, done,
        families={"B6": ("tensor_sketch_kernel",),
                  "B5": ("rm_attention_chunked_kernel",)})
    kernels["B6"]["decode_step_device_ms"] = shares["decode step"]["B6"]
    kernels["B6"]["prefill_256_device_ms"] = \
        shares["prefill bucket 256"]["B6"]
    kernels["B5"]["ts_prefill_256_device_ms"] = \
        shares["prefill bucket 256"]["B5"]

    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # -- 11. B3 and B4 against their plain versions -------------------------
    hcfg, hd, hf = noncausal_phase(torch, np, gen, kernels)
    nh = hcfg.num_heads

    # -- 12. small end-to-end references on the hubert SMOKE encoder --------
    rm_counters = {"B1": rm_feature_fused, "B2": rm_fused_causal,
                   "B3": rm_fused_state, "B4": rm_fused_apply,
                   "B5": rm_attention_chunked, "B6": tensor_sketch_fused,
                   "B7": ctr_feature_fused, "B8": structured_feature_fused,
                   "B9": rm_feature_bucket}

    def counts():
        return {kid: fn.launches for kid, fn in rm_counters.items()}

    def launched_since(before):
        """The kernels launched since ``before = counts()``, with counts."""
        return {kid: n_ - before[kid] for kid, n_ in counts().items()
                if n_ != before[kid]}

    small_rm = None
    d_small = get_config("hubert-xlarge", smoke=True).d_model
    emb_small = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 40, d_small)).astype(np.float32))
    for est in ("rm", "tensor_sketch"):
        small = dataclasses.replace(
            get_config("hubert-xlarge", smoke=True, attention_mode="rm",
                       estimator=est), compute_dtype="float32")
        cpu_params = tt.init_model(small, torch.Generator().manual_seed(0))
        gpu_params = to_cuda(cpu_params)
        before = counts()
        with torch.inference_mode():
            ref_logits, _ = tt.forward(cpu_params, small,
                                       {"embeds": emb_small})
            gpu_logits, _ = tt.forward(gpu_params, small,
                                       {"embeds": emb_small.cuda()})
        ran = launched_since(before)
        rel = rel_err(torch, gpu_logits, ref_logits)
        rel_attn = rel_err(
            torch, first_attention(torch, gpu_params, small,
                                   {"embeds": emb_small.cuda()}),
            first_attention(torch, cpu_params, small, {"embeds": emb_small}))
        print(f"[small enc] hubert SMOKE fp32 {est}, card vs CPU: logits rel "
              f"err {rel:.2e}, first layer's attention rel err "
              f"{rel_attn:.2e} (tol {E2E_TOL:.0e}); forward launches {ran}")
        want_ran = ({"B3": small.num_layers, "B4": small.num_layers}
                    if est == "rm" else {"B6": 2 * small.num_layers})
        if not (rel <= E2E_TOL and rel_attn <= E2E_TOL and ran == want_ran
                and torch.isfinite(gpu_logits).all()):
            raise AssertionError(f"small encoder {est} end-to-end check "
                                 "failed")
        if est == "rm":
            small_rm = (small, gpu_params)
    small, params = small_rm
    off = dataclasses.replace(small, rm=dataclasses.replace(
        small.rm, fuse_featurize="off"))
    with torch.inference_mode():
        fused_logits, _ = tt.forward(params, small,
                                     {"embeds": emb_small.cuda()})
        before = counts()
        off_logits, _ = tt.forward(params, off, {"embeds": emb_small.cuda()})
        torch.cuda.synchronize()
    ran = launched_since(before)
    rel = rel_err(torch, off_logits, fused_logits)
    print(f"[small enc] hubert SMOKE fp32 rm on the card, two-launch (B1 + "
          f"einsums: {ran}) vs fused (B3 + B4): logits rel err {rel:.2e} "
          f"(tol {E2E_TOL:.0e})")
    if not (rel <= E2E_TOL and ran == {"B1": 2 * small.num_layers}):
        raise AssertionError("encoder rm two-launch vs fused check failed")
    del small_rm, params

    # -- 13. the encoder slice at full width and depth ----------------------
    from repro_torch.train.steps import (
        init_params,
        make_eval_step,
        make_prefill_step,
    )

    layers = hcfg.num_layers
    print(f"[enc] {hcfg.name}: {layers} layers, d_model {hcfg.d_model}, "
          f"{hcfg.num_heads} heads, head_dim {hd}, d_ff {hcfg.d_ff}, vocab "
          f"{hcfg.vocab_size}, attention_mode rm (non-causal, fused: "
          f"F={hf}), {hcfg.compute_dtype} compute; depth cut: none")
    builds = _build.build_report()
    print("[enc] build of the encoder's two kernels (in parallel with the "
          "others): " + ", ".join(f"{n_} {builds[n_][0]:.2f}s" for n_ in
                                  ("rm_fused_state", "rm_fused_apply")))
    t0 = time.perf_counter()
    master = init_params(hcfg, seed=0)            # fp32, on the card
    # the compute copy once (bf16 weights, packed omegas), as a server
    # would hold it: each step's own cast then copies nothing
    hparams = tt.cast_params_to_compute(master, hcfg)
    del master
    hgen = torch.Generator(device="cuda")
    hgen.manual_seed(1)
    encode = make_prefill_step(hcfg, hcfg.max_seq_len)
    eval_step = make_eval_step(hcfg)
    embeds = torch.randn((ENC_CLIPS, ENC_FRAMES, hcfg.d_model),
                         generator=hgen, device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    print(f"[enc] weights ready in {time.perf_counter() - t0:.2f}s; input "
          f"embeds {tuple(embeds.shape)} bf16")
    want_per_encode = {"B3": layers, "B4": layers}

    def timed_encode(batch):
        torch.cuda.synchronize()
        before = counts()
        t0 = time.perf_counter()
        logits, cache = encode(hparams, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = launched_since(before)
        b_, t_ = batch["embeds"].shape[:2]
        if cache is not None or logits.shape != (b_, t_, hcfg.vocab_size) \
                or not torch.isfinite(logits).all():
            raise AssertionError(f"encode: logits {tuple(logits.shape)} not "
                                 f"finite or of the wrong shape")
        if ran != want_per_encode:
            raise AssertionError(f"encode launches {ran} != "
                                 f"{want_per_encode}")
        return logits, wall

    torch.cuda.reset_peak_memory_stats()
    for fn in rm_counters.values():
        fn.launches = 0
    walls = []
    for _ in range(3):
        logits, wall = timed_encode({"embeds": embeds})
        walls.append(wall)
    enc_launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    frames = ENC_CLIPS * ENC_FRAMES
    warm = sum(walls[1:]) / len(walls[1:])
    enc_rm_warm = warm
    print(f"[enc] 3 encodes of {ENC_CLIPS} x {ENC_FRAMES} frames: walls "
          + " / ".join(f"{1e3 * w_:.2f}" for w_ in walls)
          + f" ms (first cold), warm {frames / warm:.0f} frames/s, peak "
          f"memory {peak_gb:.2f} GiB; launches "
          + " ".join(f"{k_} {v_}" for k_, v_ in enc_launches.items()))
    kernels["B3"]["launches"] = enc_launches["B3"]
    kernels["B4"]["launches"] = enc_launches["B4"]
    alone, _ = timed_encode({"embeds": embeds[3:4]})
    gap = rel_err(torch, alone, logits[3:4])
    print(f"[enc] clip 3 alone vs batched: logits rel gap {gap:.3e} (tol "
          f"{BF16_LOGITS_TOL:.0e})")
    if not gap <= BF16_LOGITS_TOL:
        raise AssertionError(f"clip 3 alone differs from batched: {gap}")
    targets = torch.randint(0, hcfg.vocab_size, (ENC_CLIPS, ENC_FRAMES),
                            generator=hgen, device="cuda")
    metrics = eval_step(hparams, {"embeds": embeds, "targets": targets})
    ce = metrics["ce"].item()
    # at init the final layernorm gives each frame unit variance, so each
    # logit is N(0, d_model init_std^2) and the expected CE of random
    # targets is ln V + d_model init_std^2 / 2 (6.478 here, not ln 504)
    ce_init = math.log(hcfg.vocab_size) + hcfg.d_model * hcfg.init_std ** 2 / 2
    print(f"[enc] eval_step: ce {ce:.4f} (ln {hcfg.vocab_size} = "
          f"{math.log(hcfg.vocab_size):.4f}, expected at init {ce_init:.4f}),"
          f" z_loss {metrics['z_loss'].item():.3e}, tokens "
          f"{metrics['tokens'].item():.0f}")
    if not (math.isfinite(ce) and abs(ce - ce_init) <= 0.1):
        raise AssertionError(f"eval ce {ce} not finite or not near "
                             f"{ce_init}")
    del logits, alone
    long_emb = torch.randn((1, LONG_FRAMES, hcfg.d_model), generator=hgen,
                           device="cuda").to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    _, wall = timed_encode({"embeds": long_emb})
    print(f"[enc] long encode 1 x {LONG_FRAMES} frames (the reference's "
          f"prefill_32k length; batch cut from 32 to 1): wall "
          f"{1e3 * wall:.2f} ms, {LONG_FRAMES / wall:.0f} frames/s, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"B3 {rm_fused_state.last_schedule.blocks} blocks a launch "
          f"({rm_fused_state.last_schedule.splits} key splits)")
    # the long encode's first attention layer in fp32 (the same weights
    # and frames): the card (B3 + B4) against the plain path on the CPU
    f32 = dataclasses.replace(hcfg, compute_dtype="float32")
    master = init_params(hcfg, seed=0)
    first = {**master, "layers": master["layers"][:1]}
    del master
    first_cpu = to_cuda(first, "cpu")
    before = counts()
    attn_gpu = first_attention(torch, first, f32, {"embeds": long_emb})
    torch.cuda.synchronize()
    ran = launched_since(before)
    attn_cpu = first_attention(torch, first_cpu, f32,
                               {"embeds": long_emb.cpu()})
    rel = rel_err(torch, attn_gpu, attn_cpu)
    print(f"[enc] long encode's first attention layer, fp32: card ({ran}) "
          f"vs the plain path on the CPU: rel err {rel:.2e} (tol "
          f"{E2E_TOL:.0e})")
    if not (rel <= E2E_TOL and ran == {"B3": 1, "B4": 1}
            and torch.isfinite(attn_gpu).all()):
        raise AssertionError("long encode's first attention layer differs "
                             "from the plain path")
    del long_emb, first, first_cpu, attn_gpu, attn_cpu

    # -- 14. where the encoder's time goes (warm) ---------------------------
    def encode_once():
        encode(hparams, {"embeds": embeds})

    encode_once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encode_once()
    t_enqueued = time.perf_counter()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    enqueue_ms = (t_enqueued - t0) * 1e3
    busy_ms, by_name, count, ops_ms = device_profile(torch, encode_once)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"[enc time] encode {ENC_CLIPS} x {ENC_FRAMES}: wall {wall_ms:.2f} "
          f"ms, host enqueue {enqueue_ms:.2f} ms, device busy {busy_ms:.2f} "
          f"ms ({100 * busy_ms / wall_ms:.0f}%, idle "
          f"{100 * (1 - busy_ms / wall_ms):.0f}%), {count} device kernels, "
          f"{ops_ms:.2f} ms inside profiled operators (profiler on); top "
          "kernels " + "; ".join(f"{name[:56]} {ms:.3f} ms"
                                  for name, ms in top))
    for name, ms in by_name.items():
        if "rm_fused_state" in name or "rm_fused_apply" in name:
            print(f"[enc time] {name[:64]}: {ms:.3f} ms over the encode "
                  f"({100 * ms / busy_ms:.1f}% of device busy)")

    del hparams, embeds, targets, metrics
    gc.collect()
    torch.cuda.empty_cache()

    # -- 15. B7 and B8 against their plain versions -------------------------
    ctr_cfg = get_config("qwen3-1.7b", attention_mode="rm", estimator="ctr")
    st_cfg = get_config("qwen3-1.7b", attention_mode="rm",
                        estimator="structured")
    ctr_plan = rm_plan_for(ctr_cfg, dh)
    st_plan = rm_plan_for(st_cfg, dh)
    ctr_params = init_ctr_params(ctr_plan, gen)
    st_params = init_structured_params(st_plan, gen)
    ctr_packed = pack_ctr(ctr_plan, ctr_params)
    st_packed = pack_structured(st_plan, st_params)
    print(f"[plan] qwen3-1.7b ctr head: degrees {ctr_plan.degrees} complex "
          f"counts {ctr_plan.counts}, wr/wi {tuple(ctr_packed[0].shape)}, "
          f"F={ctr_plan.output_dim} features")
    print(f"[plan] qwen3-1.7b structured head: degrees {st_plan.degrees} "
          f"counts {st_plan.counts}, stacks {st_plan.stacks_per_bucket} of "
          f"d_pad {st_plan.d_pad}, d1/d2 {tuple(st_packed[0].shape)}, "
          f"{st_plan.padded_num_cols} columns computed, F="
          f"{st_plan.output_dim} features")
    h_st_cfg = get_config("hubert-xlarge", attention_mode="rm",
                          estimator="structured")
    h_st_plan = rm_plan_for(h_st_cfg, hd)
    h_st_packed = pack_structured(h_st_plan,
                                  init_structured_params(h_st_plan, gen))
    # (kernel id, wrapper, plain version, cost, tolerance, the kernel's
    # name, its family's registry name and params, cases of (rows, label,
    # plan, packed weights)): every row count each slice gives its kernel
    # (as for B6), a ragged count, and for B8 one hubert clip (x at width 80)
    feature_specs = (
        ("B7", ctr_feature_fused, ctr_feature_fused_ref, ctr_cost, B7_TOL,
         "ctr_feature_kernel", "ctr", ctr_params,
         [(rows, label, ctr_plan, ctr_packed)
          for rows, label in b6_shapes + [(70, "ragged")]]),
        ("B8", structured_feature_fused, structured_feature_fused_ref,
         structured_cost, B8_TOL, "structured_feature_kernel", "structured",
         st_params,
         [(rows, label, st_plan, st_packed)
          for rows, label in b6_shapes + [(70, "ragged")]]
         + [(ENC_FRAMES * nh, "hubert clip", h_st_plan, h_st_packed)]),
    )
    new_checks = {"B7": [], "B8": []}
    plan_rows = {}             # B8 through apply_structured_plan
    report_build(torch, "B7", "ctr_feature")
    report_build(torch, "B8", "structured_feature", tensor_cores=False)
    for (kid, fn, ref, cost, tol_, kname, family, fparams,
         cases) in feature_specs:
        for rows, label, kplan, packed in cases:
            cd_, cs_ = plan_columns(kplan, "cuda")
            width = kplan.input_dim
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).split(".")[-1]
                x = unit_rows(torch, (rows, width), gen).to(dtype)
                args = (x, *(p_.to(dtype) for p_ in packed), cd_, cs_)
                got = fn(*args)
                want = ref(*args)
                # two calls bitwise equal (one thread an output, no atomics)
                repeat_ok = torch.equal(got, fn(*args))
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                tol = tol_ * max(1.0, want.abs().max().item())
                # B8's surplus columns carry scale 0 and must come out 0
                surplus_ok = kid != "B8" or not got[:, cs_ == 0].any()
                # the kernel's device time (profiler), and CUDA events over
                # back-to-back wrapper calls as for B1-B6 (host-bound where
                # the host enqueues a call more slowly than the card runs it)
                ms = kernel_device_ms(torch, lambda: fn(*args), kname)
                event_ms = time_ms(torch, lambda: fn(*args))
                plain_ms = time_ms(torch, lambda: ref(*args))
                nbytes, ops = cost(rows, kplan, x.element_size())
                bms, by = bound(nbytes, ops, dname)
                extra = ""
                if kid == "B7":
                    tcms, tcby = tensor_core_bound(nbytes, ops, 0, dname,
                                                   True)
                    grid = -(-rows // 16) * -(-kplan.num_complex // 32)
                    extra = (f", tensor-core bound {tcms:.6f} ms ({tcby}); "
                             f"grid {grid} blocks of 4 warps (16 rows x 32 "
                             f"columns); two calls bitwise equal {repeat_ok}")
                else:
                    sched = structured_feature_fused.last_schedule
                    grid = sched.blocks
                    extra = (f"; grid {grid} blocks of {sched.warps} warps ("
                             + (f"{sched.lanes_per_row} lanes a row, "
                                f"{sched.elems_per_lane} points a lane"
                                if not sched.wide else
                                f"a block a row, {sched.elems_per_lane} "
                                "points a thread")
                             + f"); two calls bitwise equal {repeat_ok}")
                print(f"[{kid}] {label} x[{rows},{width}] {dname}: "
                      f"max_abs_err {err:.3e} (tol {tol:.1e}) kernel "
                      f"{ms:.4f} ms (events {event_ms:.4f} ms), plain "
                      f"{plain_ms:.4f} ms, bound {bms:.5f} ms ({by})"
                      + extra)
                if not (err <= tol and surplus_ok and repeat_ok):
                    raise AssertionError(f"{kid} {label} {dname}: error {err}"
                                         f" > {tol}, surplus not 0 or two "
                                         "calls differ")
                new_checks[kid].append((f"{label} {dname}", err, tol))
                if kid == "B8" and dtype == torch.float32 and \
                        label in ("decode", "prefill bucket 256"):
                    plan_rows.update(structured_plan_check(
                        torch, label, x, kplan, fparams, packed, got, bms,
                        new_checks))
                if label == "decode" and dtype == torch.float32:
                    hus = host_us(torch, lambda: fn(*args))
                    xs32 = x.reshape(4, cfg.num_heads, 1, width)
                    entry = registry.get(family)
                    apply_us = host_us(torch, lambda: entry.apply(
                        kplan, fparams, xs32, packed=packed))
                    print(f"[{kid}] decode host time {hus:.1f} us a call; "
                          f"the whole featurize (registry apply) "
                          f"{apply_us:.1f} us")
                    shape = (f"x[{rows},{width}] fp32 x "
                             f"{tuple(packed[0].shape)} x2")
                    kernels[kid] = dict(
                        name=fn.__name__, route="cuda",
                        source=("src/repro_torch/csrc/ctr_feature.cu"
                                if kid == "B7" else
                                "src/repro_torch/csrc/structured_feature.cu"),
                        replaces=("src/repro/kernels/ctr_feature/"
                                  "ctr_feature.py:89" if kid == "B7" else
                                  "src/repro/kernels/structured_feature/"
                                  "structured_feature.py:102"),
                        shape=shape, ms=ms, events_ms=event_ms,
                        plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                        library_ms=None, host_us=hus)
                    if kid == "B7":
                        kernels[kid].update(bound_ms=tcms, bound_by=tcby,
                                            bound_cuda_core_ms=bms, grid=grid)
                    if kid == "B8":
                        kernels[kid].update(grid=grid)
                elif dtype == torch.float32 and rows == 4096:
                    kernels[kid].update(
                        prefill_shape=f"x[{rows},{width}] fp32",
                        prefill_ms=ms, prefill_events_ms=event_ms,
                        prefill_plain_ms=plain_ms,
                        prefill_bound_ms=tcms if kid == "B7" else bms,
                        prefill_grid=grid)
                    if kid == "B7":
                        kernels[kid]["prefill_bound_cuda_core_ms"] = bms
                del x, args, got, want
    # the Gram entry point over each family's apply: card against CPU
    for kid, name, kplan, kparams, fn in (
            ("B7", "ctr", ctr_plan, ctr_params, ctr_feature_fused),
            ("B8", "structured", st_plan, st_params,
             structured_feature_fused)):
        entry = registry.get(name)
        cpu_params = {k_: v_.cpu() for k_, v_ in kparams.items()}
        for prec in ("fp32", "bf16"):
            before = fn.launches
            g_card = registry.estimate_gram(
                lambda a: entry.apply(kplan, kparams, a, precision=prec), xg)
            torch.cuda.synchronize()
            if fn.launches != before + 1:
                raise AssertionError(f"estimate_gram did not launch {kid} "
                                     "once")
            g_plain = registry.estimate_gram(
                lambda a: entry.apply(kplan, cpu_params, a, precision=prec),
                xg.cpu())
            err = (g_card.cpu() - g_plain).abs().max().item()
            tol = FEATURE_GRAM_TOL * max(1.0, g_plain.abs().max().item())
            print(f"[{kid}] estimate_gram X[4096,{dh}] {prec}: max_abs_err "
                  f"{err:.3e} (tol {tol:.1e}), Gram {tuple(g_card.shape)}")
            if not (err <= tol and torch.isfinite(g_card).all()):
                raise AssertionError(f"{kid} Gram {prec}: error {err} > {tol}")
            new_checks[kid].append((f"gram {prec}", err, tol))
    plan_rows.update(structured_split_phase(
        torch, gen, structured_feature_fused, structured_feature_fused_ref,
        new_checks["B8"]))
    for kid, checks in new_checks.items():
        label, err, tol = worst(checks)
        kernels[kid].update(max_abs_err=err, tol=tol, check=label)
    kernels["B8"].update(plan_rows)

    # -- 16. B5 at the ctr features' ragged width ---------------------------
    ctr_entry = registry.get("ctr")
    bh, t, chunk = cfg.num_heads, 256, cfg.rm.chunk
    xq = unit_rows(torch, (bh * t, dh), gen)
    xk = unit_rows(torch, (bh * t, dh), gen)
    zq = ctr_entry.apply(ctr_plan, ctr_params, xq).reshape(1, bh, t, -1)
    zk = ctr_entry.apply(ctr_plan, ctr_params, xk).reshape(1, bh, t, -1)
    kvalid = torch.ones((bh, t), device="cuda")
    kvalid[bh // 2:, 200:] = 0.0
    zk = zk * kvalid[None, :, :, None]
    v = torch.randn((1, bh, t, dh), generator=gen, device="cuda")
    f_ctr = zq.shape[-1]
    b5_checks += b5_check(torch, f"T{t} F{f_ctr}", zq, zk, v, chunk,
                          cfg.rm.eps, kernels, False)
    label, err, tol = worst(b5_checks)
    kernels["B5"].update(max_abs_err=err, tol=tol, check=label)
    del xq, xk, zq, zk, v

    # -- 17. small end-to-end references for ctr and structured -------------
    for est in ("ctr", "structured"):
        small = dataclasses.replace(
            get_config("qwen3-1.7b", smoke=True, attention_mode="rm",
                       estimator=est), compute_dtype="float32")
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, small.vocab_size, size=(2, 40)))
        cpu_params = tt.init_model(small, torch.Generator().manual_seed(0))
        gpu_params = to_cuda(cpu_params)
        before = counts()
        with torch.inference_mode():
            ref_logits, _ = tt.forward(cpu_params, small, {"tokens": toks})
            gpu_logits, _ = tt.forward(gpu_params, small,
                                       {"tokens": toks.cuda()})
        ran = launched_since(before)
        rel = rel_err(torch, gpu_logits, ref_logits)
        small_tokens = {}
        for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            sched = Scheduler(small, params, num_slots=2, max_len=64,
                              device=dev)
            for rid, n in enumerate((5, 20, 37)):
                sched.submit(Request(rid, np.random.default_rng(
                    rid).integers(0, small.vocab_size, size=n),
                    max_new_tokens=8))
            small_tokens[dev] = {r: s.generated
                                 for r, s in sched.run().items()}
        same = small_tokens["cpu"] == small_tokens["cuda"]
        kid = "B7" if est == "ctr" else "B8"
        want_ran = {kid: 2 * small.num_layers, "B5": small.num_layers}
        print(f"[small] qwen3 SMOKE fp32 {est}, card vs CPU: forward logits "
              f"rel err {rel:.2e} (tol {E2E_TOL:.0e}), greedy tokens "
              f"identical: {same}; forward launches {ran}")
        if not (rel <= E2E_TOL and same and ran == want_ran
                and torch.isfinite(gpu_logits).all()):
            raise AssertionError(f"small {est} end-to-end check failed")
        small = dataclasses.replace(
            get_config("hubert-xlarge", smoke=True, attention_mode="rm",
                       estimator=est), compute_dtype="float32")
        cpu_params = tt.init_model(small, torch.Generator().manual_seed(0))
        gpu_params = to_cuda(cpu_params)
        before = counts()
        with torch.inference_mode():
            ref_logits, _ = tt.forward(cpu_params, small,
                                       {"embeds": emb_small})
            gpu_logits, _ = tt.forward(gpu_params, small,
                                       {"embeds": emb_small.cuda()})
        ran = launched_since(before)
        rel = rel_err(torch, gpu_logits, ref_logits)
        rel_attn = rel_err(
            torch, first_attention(torch, gpu_params, small,
                                   {"embeds": emb_small.cuda()}),
            first_attention(torch, cpu_params, small, {"embeds": emb_small}))
        print(f"[small enc] hubert SMOKE fp32 {est}, card vs CPU: logits rel "
              f"err {rel:.2e}, first layer's attention rel err "
              f"{rel_attn:.2e} (tol {E2E_TOL:.0e}); forward launches {ran}")
        if not (rel <= E2E_TOL and rel_attn <= E2E_TOL
                and ran == {kid: 2 * small.num_layers}
                and torch.isfinite(gpu_logits).all()):
            raise AssertionError(f"small encoder {est} end-to-end check "
                                 "failed")
    del cpu_params, gpu_params, small_tokens

    # -- 18.-21. the ctr and structured slices, and where their time goes ---
    layers = cfg.num_layers
    for est, kid, tag in (("ctr", "B7", "ctr"),
                          ("structured", "B8", "st")):
        scfg = get_config("qwen3-1.7b", attention_mode="rm", estimator=est)
        splan = rm_plan_for(scfg, dh)
        print(f"[{tag} slice] {scfg.name}: the same model with estimator "
              f"{est} (F={splan.output_dim} features, two-launch attention, "
              f"{kid} for every featurize); depth cut: none")
        t0 = time.perf_counter()
        engine = make_engine("qwen3-1.7b", smoke=False, attention_mode="rm",
                             estimator=est, num_slots=4, max_len=256, seed=0,
                             device="cuda")
        torch.cuda.synchronize()
        print(f"[{tag} slice] weights + engine ready in "
              f"{time.perf_counter() - t0:.2f}s; estimator "
              f"{engine.estimator}, fused attention {engine.fused_attention}")
        if engine.estimator != est or engine.fused_attention:
            raise AssertionError(f"the {est} engine is not on the two-launch "
                                 "path")
        done, launches = serve_slice(
            torch, f"{tag} slice", engine, scfg, prompts, all_counters,
            lambda adm, steps, kid=kid: {
                "B1": 0, "B2": 0, "B5": adm * layers, "B6": 0, "B7": 0,
                "B8": 0, "B9": 0, kid: 2 * layers * (adm + steps)})
        kernels[kid]["launches"] = launches[kid]
        shares = where_time_goes(
            torch, tag, engine, prompts, done,
            families={kid: (f"{est}_feature_kernel",),
                      "B5": ("rm_attention_chunked_kernel",)})
        kernels[kid]["decode_step_device_ms"] = shares["decode step"][kid]
        kernels[kid]["prefill_256_device_ms"] = \
            shares["prefill bucket 256"][kid]
        kernels["B5"][f"{tag}_prefill_256_device_ms"] = \
            shares["prefill bucket 256"]["B5"]
        del engine
        gc.collect()
        torch.cuda.empty_cache()

    # -- 22. B9 against its plain version -----------------------------------
    from repro_torch.core import (
        ExponentialDotProductKernel,
        HomogeneousPolynomialKernel,
        PolynomialKernel,
        RMFeatureMap,
        constants_for,
        make_feature_map,
        train_kernel_svm,
        train_linear,
    )
    from repro_torch.data import make_classification_dataset

    poly10 = PolynomialKernel(10, 1.0)
    homog10 = HomogeneousPolynomialKernel(10)
    spam = make_classification_dataset("spambase")
    fm_spam = make_feature_map(poly10, 57, 500, seed=0)
    fm_h4000 = make_feature_map(homog10, 50, 4000, seed=0)
    fm_exp = make_feature_map(ExponentialDotProductKernel(1.0), 50, 4000,
                              seed=4000)            # Fig. 1's exp D 4000
    print(f"[B9] the spambase map (poly10, d 57, D 500): degrees "
          f"{fm_spam.degrees} counts {fm_spam.counts}; homog10 D 4000: "
          f"degrees {fm_h4000.degrees} counts {fm_h4000.counts}; exp D "
          f"4000: degrees {fm_exp.degrees} counts {fm_exp.counts}")
    ragged_omega = (2 * torch.randint(0, 2, (1, 57), generator=gen,
                                      device="cuda") - 1).float()
    # (label, x, omega, degree, scale): every bucket of Table 1's spambase
    # map at its 1840-row test split, homog10 at D 4000 at Fig. 1's 100
    # rows and Table 1's 20000-row cap, the deepest bucket of Fig. 1's exp
    # map at D 4000 at 100 rows, a ragged 70 x count 1 x degree 1
    b9_cases = [(f"spambase deg {n} x{c}", spam["x_test"], om, n, sc)
                for n, c, sc, om in zip(fm_spam.degrees, fm_spam.counts,
                                        fm_spam.scales,
                                        fm_spam.bucket_omegas())]
    for rows in (100, 20000):
        xh = unit_rows(torch, (rows, 50), gen) / 1.01
        b9_cases.append((f"homog10 D4000 rows {rows}", xh,
                         fm_h4000.bucket_omegas()[0], 10,
                         fm_h4000.scales[0]))
    b9_cases.append((f"exp D4000 deg {fm_exp.degrees[-1]} x"
                     f"{fm_exp.counts[-1]}", xh[:100],
                     fm_exp.bucket_omegas()[-1], fm_exp.degrees[-1],
                     fm_exp.scales[-1]))
    b9_cases.append(("ragged 70 x1 deg 1", spam["x_test"][:70],
                     ragged_omega, 1, 0.5))
    # a general omega (Gaussian: its TF32 remainder term must run) on the
    # tile and on a chain, and d on both sides of the tile's shared-memory
    # limit at degree 2 (fp32 d 208 takes the tile, d 216 the chain)
    gauss = [torch.randn((400 * 10, 50), generator=gen, device="cuda"),
             torch.randn((11, 50), generator=gen, device="cuda")]
    b9_cases.append(("gaussian omega x[4096,50] deg 10 x400",
                     unit_rows(torch, (4096, 50), gen), gauss[0], 10, 0.37))
    b9_cases.append(("gaussian omega x[100,50] deg 11 x1", xh[:100],
                     gauss[1], 11, 0.37))
    for d_deep in (208, 216):
        b9_cases.append((
            f"deep d x[4096,{d_deep}] deg 2 x256",
            unit_rows(torch, (4096, d_deep), gen),
            (2 * torch.randint(0, 2, (512, d_deep), generator=gen,
                               device="cuda") - 1).float(), 2, 0.5))
    report_build(torch, "B9", "rm_feature_bucket")
    b9_checks = []
    for label, x32, om32, deg, sc in b9_cases:
        rows, d_ = x32.shape
        count = om32.shape[0] // deg
        general = label.startswith("gaussian")
        for dtype in ((torch.float32,) if general
                      else (torch.float32, torch.bfloat16)):
            dname = str(dtype).split(".")[-1]
            x, om = x32.to(dtype), om32.to(dtype)
            item = x.element_size()
            got = rm_feature_bucket(x, om, deg, sc)
            again = rm_feature_bucket(x, om, deg, sc)
            want = rm_feature_bucket_ref(x, om, deg, sc)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = B9_TOL * max(1.0, want.abs().max().item())
            same = torch.equal(got, again)
            iters = 20 if rows * count > 10**7 else 50
            # CUDA events over back-to-back wrapper calls, and the kernel's
            # own device time (profiler): a small bucket's launch takes
            # less device time than the host needs to enqueue the next
            ms = time_ms(torch, lambda: rm_feature_bucket(x, om, deg, sc),
                         iters=iters)
            dev_ms = kernel_device_ms(
                torch, lambda: rm_feature_bucket(x, om, deg, sc),
                "rm_feature_bucket", iters=iters)
            plain_ms = time_ms(torch, lambda: rm_feature_bucket_ref(
                x, om, deg, sc), iters=iters)
            nbytes, ops = bucket_cost(rows, count, deg, d_, item)
            bms, by = bound(nbytes, ops, dname)
            tcms, tcby = tensor_core_bound(nbytes, ops, 0, dname,
                                           exact_w=not general)
            sched = bucket_schedule(rows, count, d_, deg, item)
            grid = (f"{sched.kernel} kernel, grid {sched.grid[0]} x "
                    f"{sched.grid[1]} blocks of {sched.rows} rows")
            if sched.kernel == "tile":
                grid += (f", runs of {sched.ct_per_warp} column tiles, "
                         f"{sched.runs} a block, {sched.buffers} buffer(s), "
                         f"{sched.smem} B shared")
            print(f"[B9] {label}: x[{rows},{d_}] omega[{count * deg},{d_}] "
                  f"{dname}: max_abs_err {err:.3e} (tol {tol:.1e}), two "
                  f"calls bitwise equal {same}; kernel {dev_ms:.4f} ms "
                  f"device (profiler), {ms:.4f} ms events; plain "
                  f"{plain_ms:.4f} ms; bound {tcms:.5f} ms ({tcby}, tensor "
                  f"cores) / {bms:.5f} ms ({by}, CUDA cores); {grid}")
            if not (err <= tol and got.shape == (rows, count) and same):
                raise AssertionError(f"B9 {label} {dname}: error {err} > "
                                     f"{tol} or two calls differ")
            b9_checks.append((f"{label} {dname}", err, tol))
            if label == "homog10 D4000 rows 20000":
                gaps = launch_gaps(torch, lambda: rm_feature_bucket(
                    x, om, deg, sc), "rm_feature_bucket")
                print(f"[B9] {label} {dname}: one profiler window over "
                      f"{gaps['launches']} back-to-back calls: "
                      f"{json.dumps(gaps)}")
            if label == "homog10 D4000 rows 20000" and \
                    dtype == torch.float32:
                kernels["B9"] = dict(
                    name="rm_feature_bucket", route="cuda",
                    source="src/repro_torch/csrc/rm_feature_bucket.cu",
                    replaces="src/repro/kernels/rm_feature/rm_feature.py:129",
                    shape=f"x[{rows},{d_}] fp32 x omega[{count * deg},{d_}]"
                          f" degree {deg}",
                    ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                    bound_ms=tcms, bound_by=tcby, cuda_core_bound_ms=bms,
                    library_ms=None, grid=grid)
            if label.startswith("spambase deg 1 ") and \
                    dtype == torch.float32:
                hus = host_us(torch, lambda: rm_feature_bucket(x, om, deg,
                                                               sc))
                print(f"[B9] host time {hus:.1f} us a wrapper call")
            del x, om, got, again, want
    # the whole per-bucket path on the adult-shaped map: B9 a bucket
    # against the fused map (B1) on the card and against the CPU's plain
    # path, with B9's launches counted
    adult = make_classification_dataset("adult")
    fm_adult = make_feature_map(poly10, 123, 4000, seed=0)
    fm_adult_cpu = RMFeatureMap(plan=fm_adult.plan,
                                omegas=fm_adult.omegas.cpu())
    xa = adult["x_test"]
    before = rm_feature_bucket.launches
    z_bucketed = apply_feature_map_bucketed(fm_adult, xa)
    z_fused = fm_adult.apply(xa)
    torch.cuda.synchronize()
    ran = rm_feature_bucket.launches - before
    z_cpu = apply_feature_map_bucketed(fm_adult_cpu, xa.cpu())
    err_f = (z_bucketed - z_fused).abs().max().item()
    tol_f = BUCKETED_TOL * max(1.0, z_fused.abs().max().item())
    err_c = (z_bucketed.cpu() - z_cpu).abs().max().item()
    tol_c = BUCKETED_TOL * max(1.0, z_cpu.abs().max().item())
    bucketed_ms = time_ms(torch, lambda: apply_feature_map_bucketed(
        fm_adult, xa), iters=20)
    fused_ms = time_ms(torch, lambda: fm_adult.apply(xa), iters=20)
    bucketed_dev = kernel_device_ms(torch, lambda: apply_feature_map_bucketed(
        fm_adult, xa), "", iters=20)
    fused_dev = kernel_device_ms(torch, lambda: fm_adult.apply(xa), "",
                                 iters=20)
    def bucketed_20():
        for _ in range(20):
            apply_feature_map_bucketed(fm_adult, xa)

    _, by_kernel, n_dev, _ = device_profile(torch, bucketed_20)
    print(f"[B9] adult map (poly10, d 123, D 4000: degrees "
          f"{fm_adult.degrees}, counts {fm_adult.counts}, const "
          f"{fm_adult.const is not None}) x[{xa.shape[0]},123]: bucketed "
          f"({ran} B9 launches) vs fused B1 max_abs_err {err_f:.3e} (tol "
          f"{tol_f:.1e}), vs the CPU's plain path {err_c:.3e} (tol "
          f"{tol_c:.1e}); bucketed {bucketed_ms:.4f} ms events, "
          f"{bucketed_dev:.4f} ms device (every kernel of the call), fused "
          f"{fused_ms:.4f} ms events, {fused_dev:.4f} ms device a featurize")
    print(f"[B9] adult map: a window of 20 bucketed calls kept {n_dev} "
          "device activities; device ms a call by kernel: "
          + "; ".join(f"{k[:70]} {v / 20:.4f}" for k, v in by_kernel.items()))
    if not (err_f <= tol_f and err_c <= tol_c
            and ran == len(fm_adult.degrees)):
        raise AssertionError("B9 bucketed path check failed")
    b9_checks += [("adult bucketed vs fused", err_f, tol_f),
                  ("adult bucketed vs CPU", err_c, tol_c)]
    label, err, tol = worst(b9_checks)
    kernels["B9"].update(max_abs_err=err, tol=tol, check=label,
                         adult_bucketed_device_ms=bucketed_dev,
                         adult_fused_device_ms=fused_dev)
    del z_bucketed, z_fused, z_cpu, fm_h4000, fm_exp, b9_cases, gauss
    gc.collect()
    torch.cuda.empty_cache()

    # -- 23. the paper's evaluation on the card -----------------------------
    from repro_torch.paper import fig1_approx, fig2_h01, table1_svm

    for fn in all_counters.values():
        fn.launches = 0
    bucketed_calls = 0         # B9 launches the phase's bucketed calls make
    t_phase = time.perf_counter()
    # Figure 1 through the port's script: Gram error against D, d 50, N 100
    fig1 = {}
    for row in fig1_approx.run(details=fig1):
        print(f"[fig1] {row}")
    for kname in fig1_approx.KERNELS:
        errs = []
        for D in fig1_approx.BUDGETS:
            got = fig1[f"fig1/{kname}/D{D}"]
            fm = got["map"]
            z_cpu = RMFeatureMap(plan=fm.plan, omegas=fm.omegas.cpu())(
                got["x"].cpu())
            g_cpu = z_cpu @ z_cpu.T
            gap = (got["gram"].cpu() - g_cpu).abs().max().item()
            gap_tol = FIG1_TOL * max(1.0, g_cpu.abs().max().item())
            print(f"[fig1] {kname} D{D}: mean |err| / scale "
                  f"{got['err']:.5f}, card vs CPU Gram {gap:.3e} (tol "
                  f"{gap_tol:.1e})")
            if not (gap <= gap_tol and torch.isfinite(got["gram"]).all()):
                raise AssertionError(f"fig1 {kname} D{D}: card vs CPU "
                                     f"{gap} > {gap_tol}")
            errs.append(got["err"])
        if not errs[-1] < errs[0]:
            raise AssertionError(f"fig1 {kname}: the error did not shrink "
                                 f"with D: {errs}")
    del fig1
    # one Gram at real size: adult-shaped, 20000 x 123, poly10 at D 4000
    xg_all = torch.cat([adult["x_train"], adult["x_test"]])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_est = fm_adult.estimate_gram(xg_all, row_chunk=4096)
    torch.cuda.synchronize()
    t_est = time.perf_counter() - t0
    g_exact = poly10.gram(xg_all)
    scale = max(1.0, g_exact.abs().max().item())
    g_err = (g_est - g_exact).abs().mean().item() / scale
    print(f"[gram] adult-shaped X[{xg_all.shape[0]},123], poly10 D 4000 "
          f"({fm_adult.output_dim} columns): Gram {tuple(g_est.shape)} "
          f"estimated in {t_est:.3f}s ({-(-xg_all.shape[0] // 4096)} "
          f"featurize chunks of <= 4096 rows and one product), mean |err| / "
          f"scale {g_err:.5f} (scale {scale:.1f})")
    n_all = xg_all.shape[0]
    if not (torch.isfinite(g_est).all() and g_est.shape == (n_all, n_all)):
        raise AssertionError(f"the {n_all} x {n_all} Gram is not finite")
    del g_est, g_exact, xg_all
    torch.cuda.empty_cache()

    # the exact SVM's captured epoch against the eager loop, bitwise
    from repro_torch.core.linear_models import _svm_epoch

    x_svm = unit_rows(torch, (300, 22), gen) * 0.9
    y_svm = torch.sign(x_svm[:, 0] * x_svm[:, 1] + 0.05)
    gram_svm = poly10.gram(x_svm)
    alpha_graph, _ = train_kernel_svm(gram_svm, y_svm, C=1.0)
    alpha_eager = torch.zeros(300, device="cuda")
    ay_eager = torch.zeros_like(alpha_eager)
    q_svm = torch.diagonal(gram_svm) + 0.5
    for _ in range(40):
        _svm_epoch(gram_svm, y_svm, q_svm, alpha_eager, ay_eager, 1.0,
                   range(300))
    torch.cuda.synchronize()
    same = torch.equal(alpha_graph, alpha_eager)
    print(f"[svm] a 300-row Gram, 40 epochs: the CUDA graph's alpha bitwise "
          f"the eager loop's {same} ({int((alpha_graph > 0).sum())} support "
          "vectors)")
    if not same:
        raise AssertionError("the SVM's captured epochs differ from the "
                             "eager loop")
    del x_svm, y_svm, gram_svm, alpha_graph, alpha_eager

    # Table 1 and Figure 2 through the port's scripts, on the card and again
    # on the CPU from the same data and draws (the card's maps, moved)
    card_maps = {}

    def card_map(kern, d_, num, seed, h01=False):
        fm = make_feature_map(kern, d_, num, seed=seed, h01=h01)
        card_maps[(kern.name, d_, num, seed, h01)] = fm
        return fm

    def cpu_map(kern, d_, num, seed, h01=False):
        fm = card_maps[(kern.name, d_, num, seed, h01)]
        return RMFeatureMap(plan=fm.plan, omegas=fm.omegas.cpu())

    names = sorted(set(table1_svm.DATASETS) | set(fig2_h01.DATASETS))
    data = {n: make_classification_dataset(n) for n in names}
    data_cpu = {n: {k_: v_.cpu() for k_, v_ in ds.items()}
                for n, ds in data.items()}
    smi_now = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    eager_svm_s = {"nursery": 6.07, "spambase": 7.41, "ijcnn": 6.73}
    for script, tag in ((table1_svm, "table1"), (fig2_h01, "fig2")):
        det_card, det_cpu = {}, {}
        rows_card = script.run(datasets=data, make_map=card_map,
                               details=det_card)
        rows_cpu = script.run(device="cpu", datasets=data_cpu,
                              make_map=cpu_map, details=det_cpu)
        names_ok = [r.split(",")[0] for r in rows_card] == \
            [r.split(",")[0] for r in rows_cpu]
        for row in rows_card:
            print(f"[{tag}] card {row}")
        for row in rows_cpu:
            print(f"[{tag}] cpu  {row}")
        for key, got in det_card.items():
            flips = (got["pred"] != det_cpu[key]["pred"]).float().mean().item()
            print(f"[{tag}] {key}: acc card {got['acc']:.4f} cpu "
                  f"{det_cpu[key]['acc']:.4f}, card vs CPU test predictions "
                  f"differ on {flips:.4%} (limit {TABLE1_FLIP_SHARE:.1%})")
            if not (flips <= TABLE1_FLIP_SHARE and names_ok):
                raise AssertionError(f"{tag} {key}: card and CPU predictions "
                                     f"differ on {flips:.4%}, or the rows "
                                     "differ")
        if tag != "table1":
            continue
        # where the exact SVM's train wall goes: one epoch (the capture and
        # one replay) against 40 (39 more replays), on nursery's Gram
        xk = data["nursery"]["x_train"][:table1_svm.N_KERNEL_TRAIN]
        yk = data["nursery"]["y_train"][:table1_svm.N_KERNEL_TRAIN]
        gram_k = poly10.gram(xk)
        svm_s = {}
        for epochs in (1, 40, 1, 40):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_kernel_svm(gram_k, yk, C=1.0, n_epochs=epochs)
            torch.cuda.synchronize()
            svm_s[epochs] = time.perf_counter() - t0
        print(f"[svm] nursery's 1200-row Gram: 1 epoch (capture + one "
              f"replay) {svm_s[1]:.3f}s, 40 epochs {svm_s[40]:.3f}s, so "
              f"{(svm_s[40] - svm_s[1]) / 39 * 1e3:.2f} ms a replay of "
              f"1200 steps (the second of two turns each)")
        del gram_k
        for name in table1_svm.DATASETS:
            trn = det_card[f"{name}/kernel"]["train_s"]
            print(f"[table1] {name} exact SVM train (Gram + 40 epochs of "
                  f"1200 coordinate steps, one CUDA graph an epoch): "
                  f"{trn:.3f}s on the card against {eager_svm_s[name]:.2f}s "
                  f"eager (PR 20), {det_cpu[f'{name}/kernel']['train_s']:.3f}s"
                  f" on the CPU; {smi_now}")
            for method in ("rf", "h01"):
                fm = det_card[f"{name}/{method}"]["map"]
                xte = data[name]["x_test"]
                z_b = apply_feature_map_bucketed(fm, xte)
                bucketed_calls += len(fm.degrees)
                zte = fm(xte)
                err = (z_b - zte).abs().max().item()
                tol = BUCKETED_TOL * max(1.0, zte.abs().max().item())
                print(f"[table1] {name} {method}: bucketed (B9) vs fused (B1)"
                      f" test features max_abs_err {err:.3e} (tol {tol:.1e})")
                if not err <= tol:
                    raise AssertionError(f"table1 {name} {method}: bucketed "
                                         f"{err} > {tol}")
        del det_card, det_cpu
    del data, data_cpu, card_maps

    # Algorithm 2 at a real size: Rademacher inner maps (B9 a bucket) for
    # poly10 at d 123, D 4000 on the adult shape; exp of RBF through RFF
    # inner maps at d 50 (plain PyTorch)
    from repro_torch.core import (
        RademacherInnerMap,
        RFFInnerMap,
        make_compositional_feature_map,
    )

    gen_c = torch.Generator(device="cuda").manual_seed(0)
    cfm = make_compositional_feature_map(
        poly10, lambda g, n: RademacherInnerMap.create(g, n, 123), 123, 4000,
        gen_c)
    xa_all = unit_rows(torch, (20000, 123), gen) * 0.95
    before = rm_feature_bucket.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z_c = cfm(xa_all)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    comp_launches = rm_feature_bucket.launches - before
    z_plain = cfm.to("cpu")(xa_all[:2000].cpu())
    err = (z_c[:2000].cpu() - z_plain).abs().max().item()
    tol = B9_TOL * max(1.0, z_plain.abs().max().item())
    counted = rm_feature_bucket.launches
    ms_c = time_ms(torch, lambda: cfm(xa_all), iters=10)
    rm_feature_bucket.launches = counted     # the timing's launches aside
    print(f"[alg2] Rademacher poly10 d 123 D 4000 ({cfm.output_dim} columns:"
          f" degrees {cfm.degrees}, counts {cfm.counts}) x[20000,123]: "
          f"{comp_launches} B9 launches ({len(cfm.degrees)} buckets), first "
          f"call {t_c:.3f}s, {ms_c:.4f} ms events a call; card vs the CPU's "
          f"plain path on 2000 rows max_abs_err {err:.3e} (tol {tol:.1e})")
    if not (err <= tol and comp_launches == len(cfm.degrees)
            and torch.isfinite(z_c).all()):
        raise AssertionError("Algorithm 2 Rademacher check failed")
    del z_c, z_plain, xa_all
    exp1 = ExponentialDotProductKernel(1.0)
    x_rbf = unit_rows(torch, (100, 50), gen) * 0.95
    k_exact = torch.exp(RFFInnerMap.create(gen_c, 1, 50).exact_kernel(
        x_rbf, x_rbf))
    alg2_errs = {}
    for D in (1000, 8000):
        rff_map = make_compositional_feature_map(
            exp1, lambda g, n: RFFInnerMap.create(g, n, 50), 50, D, gen_c,
            measure="proportional", inner_bound=2.0)
        before = rm_feature_bucket.launches
        g_card = rff_map.estimate_gram(x_rbf)
        torch.cuda.synchronize()
        launched = rm_feature_bucket.launches - before
        g_cpu = rff_map.to("cpu").estimate_gram(x_rbf.cpu())
        gap = (g_card.cpu() - g_cpu).abs().max().item()
        gap_tol = FIG1_TOL * max(1.0, g_cpu.abs().max().item())
        alg2_errs[D] = (g_card - k_exact).abs().mean().item()
        print(f"[alg2] exp of RBF (RFF inner maps) d 50 D {D}: mean |err| "
              f"{alg2_errs[D]:.5f}, card vs CPU Gram {gap:.3e} (tol "
              f"{gap_tol:.1e}), {launched} kernel launches")
        if not (gap <= gap_tol and launched == 0):
            raise AssertionError(f"alg2 RFF D {D}: card vs CPU {gap}")
    if not alg2_errs[8000] < alg2_errs[1000]:
        raise AssertionError(f"alg2 RFF: the error did not shrink with D: "
                             f"{alg2_errs}")
    # Theorem 12: features for eps-uniform error (the quickstart's numbers)
    c12 = constants_for(ExponentialDotProductKernel(1.0), radius=1.0, dim=20)
    print(f"[thm12] exp kernel, d 20, eps 0.2, delta 0.1: paper geometric "
          f"measure D >= {c12.required_d(0.2, 0.1):,}; proportional measure "
          f"D >= {c12.required_d(0.2, 0.1, 'proportional'):,}")
    torch.cuda.synchronize()
    paper_launches = {kid: fn.launches for kid, fn in all_counters.items()}
    print(f"[paper] phase 23 in {time.perf_counter() - t_phase:.2f}s; "
          "launches " + " ".join(f"{k} {v}"
                                 for k, v in paper_launches.items()))
    others = {k: v for k, v in paper_launches.items() if k not in ("B1",
                                                                    "B9")}
    if not (paper_launches["B1"] > 0
            and paper_launches["B9"] == bucketed_calls + comp_launches
            and not any(others.values())):
        raise AssertionError(f"paper phase launches {paper_launches}: B9 "
                             f"expected {bucketed_calls} + {comp_launches}, "
                             "B1 > 0, no other")
    kernels["B9"]["launches"] = paper_launches["B9"]

    # -- 24. training on the card ---------------------------------------------
    # B5's inputs at phase 5's shape: tensor_sketch features of unit rows,
    # the second half's keys padded from 200
    bh, t = cfg.num_heads, 256
    zq = ts_entry.apply(ts_plan, ts_params, unit_rows(
        torch, (bh * t, dh), gen)).reshape(1, bh, t, -1)
    zk = ts_entry.apply(ts_plan, ts_params, unit_rows(
        torch, (bh * t, dh), gen)).reshape(1, bh, t, -1)
    kvalid = torch.ones((bh, t), device="cuda")
    kvalid[bh // 2:, 200:] = 0.0
    zv = torch.randn((1, bh, t, dh), generator=gen, device="cuda")
    rm_counters = {"B1": rm_feature_fused, "B2": rm_fused_causal,
                   "B3": rm_fused_state, "B4": rm_fused_apply,
                   **{k: all_counters[k] for k in ("B5", "B6", "B7", "B8",
                                                   "B9")}}
    gc.collect()
    torch.cuda.empty_cache()
    train_phase(torch, np, kernels, rm_counters, w32, col_deg, col_scale,
                (zq, zk * kvalid[None, :, :, None], zv))
    del zq, zk, zv, kvalid
    gc.collect()
    torch.cuda.empty_cache()

    # -- 25. observability, restart recovery, exact attention -----------------
    obs_exact_phase(torch, np, kernels, rm_counters, prompts, rm_tokens,
                    enc_rm_warm)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 26. adaptive accuracy; MLA and MoE (deepseek-v2-lite-16b) ------------
    adaptive_mla_phase(torch, np, kernels, rm_counters, prompts, rm_tokens)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 27. the SSM mixers: jamba-v0.1-52b, xlstm-350m; the last configs ----
    ssm_phase(torch, np, kernels, rm_counters, prompts)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 28. meshes: the sharded estimator, data-parallel training -----------
    meshes_phase(torch, np, kernels, rm_counters)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 29. tensor parallelism over "model"; data-parallel serving ----------
    tp_runs = tensor_parallel_phase(torch, np, kernels, prompts, rm_tokens)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 30. SSM tensor parallelism, FSDP over "data", "act_seq" -------------
    ssm_fsdp_phase(torch, np, kernels, prompts, tp_runs)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 31. remat, the dry run against the card, weights cut over "data" ----
    remat_dryrun_phase(torch, np, kernels, prompts)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 32. the bucketed engine; the SMOKE-only configs at full width -------
    full_width_phase(torch, np, kernels, rm_counters, prompts, rm_tokens)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 33. the levers kv_seq_shard, vocab_unsharded and sp_data ------------
    levers_phase(torch, np, kernels, prompts)

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "tol", "check", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "shape")
    # the contract's keys first, then a kernel's own (B3 and B4: the long
    # shape's times, the bound on the fp32 CUDA cores, the grid)
    print(f"[smoke] every phase passed in {time.perf_counter() - t_main:.1f}s "
          "(the builds included)")
    print(json.dumps({"kernels": [
        {**{key: kernels[kid][key] for key in order},
         **{key: val for key, val in kernels[kid].items() if key not in order}}
        for kid in ("B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8", "B9")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
