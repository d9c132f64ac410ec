#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. environment — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions; builds both CUDA kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` each, in parallel) and prints the build time and the
   compiler's register / shared-memory report;
2. kernel B1 (``rm_feature_fused``) against its plain PyTorch version at
   the decode shape of the serving path and at a Gram shape, fp32 and bf16;
3. kernel B2 (``rm_fused_causal``) against its plain version at a prefill
   shape with padded keys, fp32 and bf16 (out, S and n);
4. a small end-to-end reference: the qwen3 SMOKE model in fp32 on the card
   (kernels) against the same weights on the CPU (plain versions);
5. the slice: qwen3-1.7b at full width and depth, RM attention, random
   weights from a seed, served by the continuous-batching Scheduler
   (4 slots, max_len 256, 8 greedy requests over several prompt buckets).
   Every request must finish, both kernels' launch counters must match the
   admissions and decode steps, and a request run alone must give the
   tokens it got in the batch;
6. where the time goes: the same workload again on the warm engine (its
   TTFT and tokens/s), then a ``torch.profiler`` window over warm decode
   steps and one bucket-256 prefill: wall time, device busy share and the
   kernels that take the device time.

It then prints one ``{"kernels": [...]}`` line (times from CUDA events over
repeated launches, bounds computed from this run's shapes) and, as its
last line, ``{"ok": true, "device": {...}}``. Without a CUDA device it
prints no result and exits non-zero.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM published peaks (dense): HBM bytes/s, fp32 (CUDA cores) and
# bf16 (tensor cores) operations/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}

VALID_REASONS = {"eos", "max_new_tokens", "cache_full"}
B1_TOL = 1e-5   # x max(1, max |plain|): fp32 sums of <= 5 x 128 products
B2_TOL = 1e-4   # x max(1, max |plain|): fp32 sums of up to T x F terms


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
    name: ms}) from the CUDA kernel events (one stream, so their durations
    add up to the busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    return sum(by_name.values()), by_name


def unit_rows(torch, shape, gen):
    x = torch.randn(shape, generator=gen, device="cuda")
    return x / x.norm(dim=-1, keepdim=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.plan import init_omegas, pack_omegas, plan_columns
    from repro_torch.kernels import _build
    from repro_torch.kernels.rm_attention.ops import rm_fused_causal
    from repro_torch.kernels.rm_attention.ref import rm_fused_causal_ref
    from repro_torch.kernels.rm_feature.ops import rm_feature_fused
    from repro_torch.kernels.rm_feature.ref import rm_feature_fused_ref
    from repro_torch.launch.serve import make_engine, summarize
    from repro_torch.models.attention import rm_plan_for
    from repro_torch.serve import Request

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
    print(f"[build] both kernels ready in {time.perf_counter() - t0:.2f}s")
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

    # -- 2. B1 against its plain version ------------------------------------
    decode_rows = 2 * 4 * cfg.num_heads          # stacked q+k, 4 slots
    b1_checks = []
    for rows, label in ((decode_rows, "decode"), (4096, "gram")):
        for dtype in (torch.float32, torch.bfloat16):
            x = unit_rows(torch, (rows, dh), gen).to(dtype)
            w = w32.to(dtype)
            got = rm_feature_fused(x, w, col_deg, col_scale)
            want = rm_feature_fused_ref(x, w, col_deg, col_scale)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = B1_TOL * max(1.0, want.abs().max().item())
            ms = time_ms(torch, lambda: rm_feature_fused(x, w, col_deg,
                                                          col_scale))
            plain_ms = time_ms(torch, lambda: rm_feature_fused_ref(
                x, w, col_deg, col_scale))
            dname = str(dtype).split(".")[-1]
            item = x.element_size()
            nbytes = (rows * dh * item + omega_bytes(deg_np, dh, item)
                      + f * 8 + rows * f * 4)
            bms, by = bound(nbytes, featurize_ops(rows, deg_np, dh), dname)
            print(f"[B1] {label} x[{rows},{dh}] {dname}: max_abs_err "
                  f"{err:.3e} (tol {tol:.1e}) kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bms:.5f} ms ({by})")
            if not err <= tol:
                raise AssertionError(f"B1 {label} {dname}: error {err} > "
                                     f"{tol}")
            b1_checks.append((f"{label} {dname}", err, tol))
            if label == "decode" and dtype == torch.float32:
                kernels["B1"] = dict(
                    name="rm_feature_fused", route="cuda",
                    source="src/repro_torch/csrc/rm_feature.cu",
                    replaces="src/repro/kernels/rm_feature/rm_feature.py:65",
                    shape=f"x[{rows},{dh}] fp32 x w{tuple(w32.shape)}",
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=None)

    # -- 3. B2 against its plain version ------------------------------------
    b, h, t = 2, cfg.num_heads // 2, 256         # BH = 16
    b2_checks = []
    for dtype in (torch.float32, torch.bfloat16):
        q = unit_rows(torch, (b, h, t, dh), gen).to(dtype)
        k = unit_rows(torch, (b, h, t, dh), gen).to(dtype)
        v = torch.randn((b, h, t, dh), generator=gen, device="cuda")
        kvalid = torch.ones((b, t), device="cuda")
        kvalid[1, 200:] = 0.0                    # a padded prompt bucket
        w = w32.to(dtype)
        args = (q, k, v, kvalid, w, col_deg, col_scale)
        got = rm_fused_causal(*args, cfg.rm.eps)
        want = rm_fused_causal_ref(*args, chunk=cfg.rm.chunk, eps=cfg.rm.eps)
        torch.cuda.synchronize()
        errs, tols = [], []
        for name, g_, w_ in zip(("out", "S", "n"), got, want):
            errs.append((g_ - w_).abs().max().item())
            tols.append(B2_TOL * max(1.0, w_.abs().max().item()))
            b2_checks.append((f"{name} {dtype}".replace("torch.", ""),
                              errs[-1], tols[-1]))
            if not errs[-1] <= tols[-1]:
                raise AssertionError(f"B2 {name} {dtype}: error {errs[-1]} "
                                     f"> {tols[-1]}")
        ms = time_ms(torch, lambda: rm_fused_causal(*args, cfg.rm.eps),
                     iters=20)
        plain_ms = time_ms(torch, lambda: rm_fused_causal_ref(
            *args, chunk=cfg.rm.chunk, eps=cfg.rm.eps), iters=20)
        dname = str(dtype).split(".")[-1]
        item = q.element_size()
        bh = b * h
        nbytes = (2 * bh * t * dh * item + bh * t * dh * 4 + b * t * 4
                  + omega_bytes(deg_np, dh, item) + f * 8 + bh * t * dh * 4
                  + bh * f * dh * 4 + bh * f * 4)
        # featurize q and k rows, then the recurrent form: S += zk v^T,
        # n += zk, num = zq S, den = zq n, divide
        ops = (2 * featurize_ops(bh * t, deg_np, dh)
               + bh * t * (4 * f * dh + 3 * f + dh))
        bms, by = bound(nbytes, ops, dname)
        print(f"[B2] q,k[{bh},{t},{dh}] {dname}: max_abs_err out/S/n "
              f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tol "
              f"{tols[0]:.1e}/{tols[1]:.1e}/{tols[2]:.1e}) kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.5f} ms "
              f"({by})")
        if dtype == torch.float32:
            kernels["B2"] = dict(
                name="rm_fused_causal", route="cuda",
                source="src/repro_torch/csrc/rm_fused_attention.cu",
                replaces="src/repro/kernels/rm_attention/fused.py:158",
                shape=f"q,k[{bh},{t},{dh}] fp32, F={f}",
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None)
    # each kernel's line reports the check nearest its limit, with that
    # check's own error and limit
    for kid, checks in (("B1", b1_checks), ("B2", b2_checks)):
        label, err, tol = worst(checks)
        kernels[kid].update(max_abs_err=err, tol=tol, check=label)

    # -- 4. small end-to-end reference: card (kernels) vs CPU (plain) -------
    import dataclasses

    from repro_torch.models import transformer as tt
    from repro_torch.serve import Scheduler

    small = dataclasses.replace(
        get_config("qwen3-1.7b", smoke=True, attention_mode="rm"),
        compute_dtype="float32")
    cpu_params = tt.init_model(small, torch.Generator().manual_seed(0))

    def to_cuda(p):
        if isinstance(p, dict):
            return {key: to_cuda(val) for key, val in p.items()}
        if isinstance(p, list):
            return [to_cuda(val) for val in p]
        return p.cuda()

    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, small.vocab_size, size=(2, 40)))
    with torch.inference_mode():
        ref_logits, _ = tt.forward(cpu_params, small, {"tokens": toks})
        gpu_logits, _ = tt.forward(to_cuda(cpu_params), small,
                                   {"tokens": toks.cuda()})
    rel = ((gpu_logits.cpu() - ref_logits).abs().max()
           / ref_logits.abs().max().clamp_min(1.0)).item()
    small_tokens = {}
    for dev, params in (("cpu", cpu_params), ("cuda", to_cuda(cpu_params))):
        sched = Scheduler(small, params, num_slots=2, max_len=64,
                          device=dev)
        for rid, n in enumerate((5, 20, 37)):
            sched.submit(Request(rid, np.random.default_rng(rid).integers(
                0, small.vocab_size, size=n), max_new_tokens=8))
        small_tokens[dev] = {r: s.generated for r, s in sched.run().items()}
    same = small_tokens["cpu"] == small_tokens["cuda"]
    print(f"[small] qwen3 SMOKE fp32, card vs CPU: forward logits rel err "
          f"{rel:.2e} (tol 1e-4), greedy tokens identical: {same}")
    if not (rel <= 1e-4 and same and torch.isfinite(gpu_logits).all()):
        raise AssertionError("small end-to-end reference check failed")

    # -- 5. the slice at full width and depth -------------------------------
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
    buckets = sorted({engine.executor.bucket_for(n) for n in lengths})
    torch.cuda.reset_peak_memory_stats()
    rm_feature_fused.launches = 0
    rm_fused_causal.launches = 0
    done, admissions, decode_steps, wall = run_workload(torch, engine,
                                                        prompts, 0)
    launches = {"B1": rm_feature_fused.launches,
                "B2": rm_fused_causal.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    stats = summarize(done)
    print(f"[slice] cold run: {stats['requests']} requests over buckets "
          f"{buckets}, {stats['tokens']} tokens in {wall:.3f}s "
          f"({stats['tokens'] / wall:.1f} tok/s), TTFT p50 "
          f"{stats['ttft_p50_s'] * 1e3:.1f} ms p99 "
          f"{stats['ttft_p99_s'] * 1e3:.1f} ms, peak memory {peak_gb:.2f} GiB")
    print(f"[slice] admissions {admissions}, decode steps {decode_steps}, "
          f"launches B1 {launches['B1']} B2 {launches['B2']}")
    for rid, s in done.items():
        if s.finish_reason not in VALID_REASONS or not s.generated or \
                not all(0 <= tok < cfg.vocab_size for tok in s.generated):
            raise AssertionError(f"request {rid}: {s.finish_reason} "
                                 f"{s.generated}")
    if launches["B2"] != admissions * cfg.num_layers or admissions < 8:
        raise AssertionError(f"B2 launches {launches['B2']} != admissions "
                             f"{admissions} x {cfg.num_layers} layers")
    if launches["B1"] != decode_steps * cfg.num_layers or not decode_steps:
        raise AssertionError(f"B1 launches {launches['B1']} != decode steps "
                             f"{decode_steps} x {cfg.num_layers} layers")
    with torch.inference_mode():
        logits, _, _ = engine.executor.prefill(prompts[0])
    if logits.shape != (1, 32, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    for rid in (7, 1):                           # padded buckets 256, 32
        engine.submit(Request(100 + rid, prompts[rid], max_new_tokens=16))
        alone = engine.run()[100 + rid].generated
        if alone != done[rid].generated:
            raise AssertionError(f"request {rid} alone {alone} != batched "
                                 f"{done[rid].generated}")
    print("[slice] requests 7 and 1 run alone give their batched tokens")

    # -- 6. where the time goes (warm) --------------------------------------
    done2, _, steps2, wall2 = run_workload(torch, engine, prompts, 1000)
    if any(done2[r].generated != done[r].generated for r in prompts):
        raise AssertionError("the warm run changed a request's tokens")
    stats2 = summarize(done2)
    print(f"[time] warm run: {stats2['tokens']} tokens in {wall2:.3f}s "
          f"({stats2['tokens'] / wall2:.1f} tok/s), TTFT p50 "
          f"{stats2['ttft_p50_s'] * 1e3:.1f} ms p99 "
          f"{stats2['ttft_p99_s'] * 1e3:.1f} ms (queue wait included), "
          f"{steps2} decode steps")
    ex = engine.executor
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
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        busy_ms, by_name = device_profile(torch, fn)
        busy_ms /= reps
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        print(f"[time] {label}: wall {wall_ms:.2f} ms, device busy "
              f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.0f}%, idle "
              f"{100 * (1 - busy_ms / wall_ms):.0f}%); top kernels "
              + "; ".join(f"{name[:48]} {ms / reps:.2f} ms"
                          for name, ms in top))
    kernels["B1"]["launches"] = launches["B1"]
    kernels["B2"]["launches"] = launches["B2"]

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "tol", "check", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "shape")
    print(json.dumps({"kernels": [{key: kernels[kid][key] for key in order}
                                  for kid in ("B1", "B2")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
