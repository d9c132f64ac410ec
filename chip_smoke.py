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
    depth (28 layers, bf16 compute, fp32 masters, AdamW) trained 8 steps
    through ``train.trainer.Trainer`` on ``SyntheticLMDataset`` (4 x 256
    tokens a step, vocab 151936), the first step cold: every step finite,
    B2 exactly 28 launches and no other RM kernel, the last step's CE
    below the first's, the final checkpoint restored bitwise; the cold and
    warm step walls, tokens/s, peak device memory beside the train state's
    bytes, and one profiled warm step (wall, device busy and idle share,
    device kernels, the largest device consumers, B2's device time beside
    its backward's recompute, and both alone at the step's shape); (d) one
    ``make_train_step`` of hubert-xlarge at full width and depth (48
    layers, 2 clips x 1500 frames, framewise targets from the seed):
    finite, B3 and B4 48 launches each, its wall and peak memory;
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
    memory.

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
in phase 25's traced serve, B1 the drift check's) and, as its last
line, ``{"ok": true, "device": {...}}``. Without a CUDA device it prints
no result and exits non-zero. Should the run near its time limit, the rm
slice's warm repeat (phase 8) is the part to cut first, then the
tensor_sketch slice's (phase 10), then phase 24's profiled warm step and
its timings alone, then phase 25's exact hubert encode (e) and its warm
exact decode timing; no kernel check and no gradient check is cut.
"""
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


def where_time_goes(torch, tag, engine, prompts, done, families=None):
    """The workload again on the warm engine (TTFT, tokens/s), then one
    profiler window over 5 warm decode steps and one over a bucket-256
    prefill. ``families``: {kernel id: substrings of its device kernels'
    names}, whose device time in each window is printed (and returned as
    {window label: {kernel id: ms a step or a prefill}})."""
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
                            ("prefill bucket 256", prefill256, 1)):
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
TRAIN_BATCH, TRAIN_SEQ = 4, 256
ENC_TRAIN_CLIPS = 2      # hubert-xlarge clips of ENC_FRAMES in its step


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

    # c. qwen3-1.7b at full width and depth through the Trainer
    cfg = get_config("qwen3-1.7b", attention_mode="rm")
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
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step; depth cut: none")
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
        state_bytes = tree_bytes(state)
        rows = trainer.metrics_log
        marks = CountedData.marks
        per_step = [{k: marks[i + 1][k] - marks[i][k] for k in counters}
                    for i in range(TRAIN_STEPS)]
        want = {k: layers if k == "B2" else 0 for k in counters}
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
              + f"; every step B2 x {layers}, no other RM kernel")
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
    kernels["B2"]["train_step_launches"] = layers

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
          f"({layers} launches); its backward's recompute (the "
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
    want = {k: hlayers if k in ("B3", "B4") else 0 for k in counters}
    if not (finite and launched == want):
        raise AssertionError(f"train d: finite {finite}, launches "
                             f"{launched} (want {want})")
    kernels["B3"]["train_step_launches"] = hlayers
    kernels["B4"]["train_step_launches"] = hlayers
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
