#!/usr/bin/env python3
"""Time kernels B1 (``rm_feature_fused``), B2 (``rm_fused_causal``), B5
(``rm_attention_chunked``), B6 (``tensor_sketch_fused``), B7
(``ctr_feature_fused``), B8 (``structured_feature_fused``) and B9
(``rm_feature_bucket``) of one source tree of the port on one CUDA card,
so that two versions of the kernels can be compared in one run on one card.

    python3 time_rm_kernels.py [--src DIR] [--kernels B1,B9,...]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's); ``--kernels`` times only the kernels named (default: all).
``--b9-schedules`` instead times B9's tile kernel under every schedule
``kernels.common.bucket_schedule`` weighs (this checkout only), the data
its cost model was fitted to.
To compare two versions, unpack the other one with
``git archive`` into a git-ignored directory and run this file once with
each ``--src``, in turns. The shapes are those of ``chip_smoke.py`` phases
2 and 3 (seeded inputs, qwen3-1.7b's rm head: d 128, F 163): B1 at the
decode shape (x ``[128, 128]``), a 4096-row Gram shape and the adult-shaped
map of the paper's evaluation (x ``[20000, 123]``, poly10, D 4000); B2 at
the bucket-256 prefill (BH 16, T 256) and a 4096-token prompt (BH 16, T
4096, its last 100 keys padded); B6 and B7 on qwen3-1.7b's
tensor_sketch and ctr heads (Fs 255, Fc 127) at the decode shape (x
``[64, 128]``) and a bucket-256 prefill's (x ``[4096, 128]``), as
``chip_smoke.py`` phases 4 and 15; B5 at phase 5's prefill shape (zq, zk
``[16, 256, 256]``, dv 128, chunk 128) and at T 32 (chunk 32), and at
phase 16's ctr width (F 255); B8 on qwen3-1.7b's structured head (6 stacks
of d_pad 128) at the decode and prefill rows, full width, and the prefill
rows through ``apply_structured_plan`` (the map: kept columns only, from
this PR's tree on; its ``device_ms`` is B8's kernel, ``all_device_ms``
every kernel of the call); B9 at phase 22's shapes: homog10's one bucket
at D 4000 (degree 10, omega ``[40000, 50]``) at x ``[20000, 50]`` and
``[100, 50]``, the spambase map's (poly10, d 57, D 500) deg-1 x125, deg-4
x16 and deg-8 x1 buckets at its 1840 test rows, exp's deepest bucket at D
4000 (deg 11 x1) at 100 rows, and the whole per-bucket path
(``apply_feature_map_bucketed``) on the adult map (poly10, d 123, D 4000)
at its 8000 test rows (``all_device_ms``: every kernel of the call); at
20000 rows also one profiler window read for where the CUDA-event time
goes beyond the kernels' (``chip_smoke.launch_gaps``); fp32 and bf16.
Each output line is one
JSON object: the CUDA-event time per call over back-to-back calls, the
profiler's device time per call of the kernels themselves, the host time
to enqueue a call (the wrapper's checks and the launch), and the largest
error against the plain version as a share of max(1, max |plain|). The
timing helpers are ``chip_smoke.py``'s. Needs a card; prints the card's
name and power limit first.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as smoke

# The device kernels of each: B1's chain and tile kernels, B2's three
# passes and the single kernel of B2's first version, so an older tree can
# be timed too; B5's, B6's, B7's and B8's kernels keep their name prefixes
# across versions.
KERNELS = {"B1": ("rm_feature_kernel",),
           "B2": ("chunk_", "rm_fused_causal_kernel"),
           "B5": ("rm_attention_chunked_kernel",),
           "B6": ("tensor_sketch_kernel",),
           "B7": ("ctr_feature_kernel",),
           "B8": ("structured_feature_kernel",),
           "B9": ("rm_feature_bucket",)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent
                                         / "src"))
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated kernels to time (default: all)")
    ap.add_argument("--b9-schedules", action="store_true",
                    help="time B9's tile kernel under every schedule its "
                         "cost model weighs")
    args = ap.parse_args(argv)
    only = set(args.kernels.split(","))
    import torch

    if not torch.cuda.is_available():
        print("time_rm_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.core import PolynomialKernel, make_feature_map
    from repro_torch.core.plan import (init_omegas, pack_omegas,
                                       plan_columns)
    from repro_torch.kernels import _build
    from repro_torch.kernels.rm_attention.ops import (rm_attention_chunked,
                                                      rm_fused_causal)
    from repro_torch.kernels.rm_attention.ref import (
        chunk_states, rm_attention_chunked_ref, rm_fused_causal_ref)
    from repro_torch.kernels.rm_feature.ops import rm_feature_fused
    from repro_torch.kernels.rm_feature.ref import rm_feature_fused_ref
    from repro_torch.models.attention import rm_plan_for
    from repro_torch.ctr.plan import init_ctr_params, pack_ctr
    from repro_torch.ctr.ref import ctr_feature_fused_ref
    from repro_torch.kernels.ctr_feature.ops import ctr_feature_fused
    from repro_torch.kernels.tensor_sketch.ops import tensor_sketch_fused
    from repro_torch.sketch.plan import init_sketch_params, pack_sketch
    from repro_torch.sketch.ref import tensor_sketch_fused_ref
    from repro_torch.kernels.structured_feature.ops import (
        structured_feature_fused)
    from repro_torch.structured.plan import (
        apply_structured_plan, init_structured_params, pack_structured)
    from repro_torch.structured.ref import structured_feature_fused_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _build.build_all()
    smoke.warm_card(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = get_config("qwen3-1.7b", attention_mode="rm")
    dh = cfg.resolved_head_dim
    plan = rm_plan_for(cfg, dh)
    w32 = pack_omegas(plan, init_omegas(plan, gen))
    cd, cs = plan_columns(plan, "cuda")
    ts_plan = rm_plan_for(get_config("qwen3-1.7b", attention_mode="rm",
                                     estimator="tensor_sketch"), dh)
    ts32 = pack_sketch(ts_plan, init_sketch_params(ts_plan, gen))
    tcd, tcs = plan_columns(ts_plan, "cuda")
    ctr_plan = rm_plan_for(get_config("qwen3-1.7b", attention_mode="rm",
                                      estimator="ctr"), dh)
    ctr32 = pack_ctr(ctr_plan, init_ctr_params(ctr_plan, gen))
    ccd, ccs = plan_columns(ctr_plan, "cuda")
    st_plan = rm_plan_for(get_config("qwen3-1.7b", attention_mode="rm",
                                     estimator="structured"), dh)
    st_params = init_structured_params(st_plan, gen)
    st32 = pack_structured(st_plan, st_params)
    scd, scs = plan_columns(st_plan, "cuda")
    fm = make_feature_map(PolynomialKernel(10, 1.0), 123, 4000, seed=0)
    if args.b9_schedules:
        sweep_b9(torch, gen, fm)
        return 0
    wa32 = pack_omegas(fm.plan, fm.omegas)
    cda, csa = plan_columns(fm.plan, "cuda")

    def emit(kid, shape, dtype, fn, plain, iters, all_kernels=False,
             gaps=False):
        if kid not in only:
            return
        got, want = fn(), plain()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        err = max(smoke.rel_err(torch, g, w_) for g, w_ in zip(got, want))
        del got, want
        row = dict(
            src=str(src), kernel=kid, shape=shape,
            dtype=str(dtype).split(".")[-1],
            events_ms=smoke.time_ms(torch, fn, iters=iters),
            device_ms=smoke.kernel_device_ms(torch, fn, KERNELS[kid],
                                             iters=iters),
            host_us=smoke.host_us(torch, fn, iters=10 * iters),
            max_rel_err=err)
        if all_kernels:
            row["all_device_ms"] = smoke.kernel_device_ms(torch, fn, "",
                                                          iters=iters)
        if gaps:
            row["gaps"] = smoke.launch_gaps(torch, fn, KERNELS[kid][0])
        print(json.dumps(row), flush=True)

    for dtype in (torch.float32, torch.bfloat16):
        for rows, w, c1, c2, label, iters in (
                (128, w32, cd, cs, "decode x[128,128] F 163", 50),
                (4096, w32, cd, cs, "gram x[4096,128] F 163", 20),
                (20000, wa32, cda, csa,
                 f"adult x[20000,123] poly10 F {wa32.shape[1]}", 5)):
            x = smoke.unit_rows(torch, (rows, w.shape[2]), gen).to(dtype)
            wt = w.to(dtype)
            emit("B1", label, dtype,
                 lambda x=x, wt=wt, c1=c1, c2=c2: rm_feature_fused(
                     x, wt, c1, c2),
                 lambda x=x, wt=wt, c1=c1, c2=c2: rm_feature_fused_ref(
                     x, wt, c1, c2), iters)
        for t, iters in ((256, 20), (4096, 5)):
            q = smoke.unit_rows(torch, (1, 16, t, dh), gen).to(dtype)
            k = smoke.unit_rows(torch, (1, 16, t, dh), gen).to(dtype)
            v = torch.randn((1, 16, t, dh), generator=gen, device="cuda")
            kvalid = torch.ones((1, t), device="cuda")
            kvalid[0, t - 100:] = 0.0
            a_ = (q, k, v, kvalid, w32.to(dtype), cd, cs)
            emit("B2", f"BH 16 T {t} F 163", dtype,
                 lambda a_=a_: rm_fused_causal(*a_, cfg.rm.eps),
                 lambda a_=a_: rm_fused_causal_ref(
                     *a_, chunk=cfg.rm.chunk, eps=cfg.rm.eps), iters)
    for dtype in (torch.float32, torch.bfloat16):
        for rows, label, iters in ((64, "decode", 50),
                                   (4096, "prefill bucket 256", 20)):
            x = smoke.unit_rows(torch, (rows, dh), gen).to(dtype)
            ta = (x, *(p_.to(dtype) for p_ in ts32[:2]), tcd,
                  *(p_.to(dtype) for p_ in ts32[2:]), tcs)
            emit("B6", f"{label} x[{rows},{dh}] Fs {ts32[0].shape[1]}", dtype,
                 lambda ta=ta: tensor_sketch_fused(
                     *ta, ts_plan.block_starts()),
                 lambda ta=ta: tensor_sketch_fused_ref(*ta), iters)
            ca = (x, *(p_.to(dtype) for p_ in ctr32), ccd, ccs)
            emit("B7", f"{label} x[{rows},{dh}] Fc {ctr32[0].shape[1]}", dtype,
                 lambda ca=ca: ctr_feature_fused(*ca),
                 lambda ca=ca: ctr_feature_fused_ref(*ca), iters)
            sa = (x, *(p_.to(dtype) for p_ in st32), scd, scs)
            emit("B8", f"{label} x[{rows},{dh}] full width "
                 f"{st_plan.padded_num_cols}", dtype,
                 lambda sa=sa: structured_feature_fused(*sa),
                 lambda sa=sa: structured_feature_fused_ref(*sa), iters)
            if rows == 4096:
                prec = "bf16" if dtype == torch.bfloat16 else "fp32"
                xf = x.float()
                emit("B8", f"{label} x[{rows},{dh}] apply_structured_plan "
                     f"F {st_plan.output_dim}", dtype,
                     lambda xf=xf, prec=prec: apply_structured_plan(
                         st_plan, st_params, xf, prec, packed=st32),
                     lambda xf=xf, prec=prec: apply_structured_plan(
                         st_plan, {k_: v_.cpu() for k_, v_ in
                                   st_params.items()}, xf.cpu(), prec),
                     iters, all_kernels=True)
    # B5 on seeded features with a constant first column (the families'
    # maps have one), the last 56 keys of half the rows zeroed (padding)
    for dtype in (torch.float32, torch.bfloat16):
        for t, chunk, f in ((256, 128, 256), (32, 32, 256), (256, 128, 255)):
            zq = 0.3 * torch.randn((16, t, f), generator=gen, device="cuda")
            zk = 0.3 * torch.randn((16, t, f), generator=gen, device="cuda")
            zq[..., 0] = zk[..., 0] = 1.0
            zk[8:, t - t // 4:] = 0.0
            zq, zk = zq.to(dtype), zk.to(dtype)
            v = torch.randn((16, t, dh), generator=gen, device="cuda")
            s_prev, n_prev = (a[0] for a in chunk_states(zk[None], v[None],
                                                         chunk))
            ba = (zq, zk, v, s_prev, n_prev)
            emit("B5", f"zq,zk[16,{t},{f}] dv {dh} chunk {chunk}", dtype,
                 lambda ba=ba, chunk=chunk: rm_attention_chunked(
                     *ba, chunk=chunk, eps=cfg.rm.eps),
                 lambda ba=ba, chunk=chunk: rm_attention_chunked_ref(
                     *ba, chunk=chunk, eps=cfg.rm.eps), 20)
    if "B9" in only:
        time_b9(torch, gen, emit, fm)
    return 0


def time_b9(torch, gen, emit, fm_adult):
    """B9 at phase 22's shapes (the module docstring), fp32 and bf16."""
    from repro_torch.core import (
        ExponentialDotProductKernel,
        HomogeneousPolynomialKernel,
        PolynomialKernel,
        RMFeatureMap,
        make_feature_map,
    )
    from repro_torch.data import make_classification_dataset
    from repro_torch.kernels.rm_feature.ops import (
        apply_feature_map_bucketed,
        rm_feature_bucket,
    )
    from repro_torch.kernels.rm_feature.ref import rm_feature_bucket_ref

    spam = make_classification_dataset("spambase")["x_test"]
    fm_spam = make_feature_map(PolynomialKernel(10, 1.0), 57, 500, seed=0)
    fm_h = make_feature_map(HomogeneousPolynomialKernel(10), 50, 4000,
                            seed=0)
    fm_exp = make_feature_map(ExponentialDotProductKernel(1.0), 50, 4000,
                              seed=4000)
    cases = []
    for rows, iters in ((20000, 20), (100, 50)):
        xh = smoke.unit_rows(torch, (rows, 50), gen) / 1.01
        cases.append((f"homog10 D4000 x[{rows},50] omega[40000,50] deg 10",
                      xh, fm_h.bucket_omegas()[0], 10, fm_h.scales[0],
                      iters))
    for i in (0, 3, 7):
        n, c = fm_spam.degrees[i], fm_spam.counts[i]
        cases.append((f"spambase x[1840,57] deg {n} x{c}", spam,
                      fm_spam.bucket_omegas()[i], n, fm_spam.scales[i], 50))
    cases.append((f"exp D4000 x[100,50] deg {fm_exp.degrees[-1]} "
                  f"x{fm_exp.counts[-1]}", xh, fm_exp.bucket_omegas()[-1],
                  fm_exp.degrees[-1], fm_exp.scales[-1], 50))
    adult = make_classification_dataset("adult")["x_test"]
    fm_cpu = RMFeatureMap(plan=fm_adult.plan, omegas=fm_adult.omegas.cpu())
    for dtype in (torch.float32, torch.bfloat16):
        for label, x32, om32, deg, sc, iters in cases:
            x, om = x32.to(dtype), om32.to(dtype)
            emit("B9", label, dtype,
                 lambda x=x, om=om, deg=deg, sc=sc: rm_feature_bucket(
                     x, om, deg, sc),
                 lambda x=x, om=om, deg=deg, sc=sc: rm_feature_bucket_ref(
                     x, om, deg, sc), iters, gaps=x.shape[0] == 20000)
        xa = adult.to(dtype)
        emit("B9", f"adult per-bucket path x[{xa.shape[0]},123] poly10 D "
             f"4000 ({len(fm_adult.degrees)} buckets + const)", dtype,
             lambda xa=xa: apply_feature_map_bucketed(fm_adult, xa),
             lambda xa=xa: apply_feature_map_bucketed(fm_cpu, xa.cpu()), 20,
             all_kernels=True)


def sweep_b9(torch, gen, fm_adult):
    """B9's tile kernel at homog10 x ``[20000, 50]`` and at the adult map's
    buckets that take the tile at its 8000 test rows, fp32 and bf16, under
    every run size that fits shared memory with two buffers (1 to 8 column
    tiles) and 1 to 32 runs a block: one JSON line a shape with each
    schedule's CUDA-event ms, the fastest, and the one
    ``bucket_schedule`` picks (its cost model was fitted to these)."""
    from repro_torch.core import HomogeneousPolynomialKernel, make_feature_map
    from repro_torch.data import make_classification_dataset
    from repro_torch.kernels.common import (
        SMEM_PER_BLOCK,
        bucket_schedule,
        bucket_tile_smem,
    )
    from repro_torch.kernels.rm_feature.ops import _bucket_launch

    fm_h = make_feature_map(HomogeneousPolynomialKernel(10), 50, 4000,
                            seed=0)
    cases = [("homog10 x[20000,50] deg 10 x4000",
              smoke.unit_rows(torch, (20000, 50), gen),
              fm_h.bucket_omegas()[0], 10)]
    adult = make_classification_dataset("adult")["x_test"]
    for n, om in zip(fm_adult.degrees, fm_adult.bucket_omegas()):
        cases.append((f"adult x[{adult.shape[0]},123] deg {n} "
                      f"x{om.shape[0] // n}", adult, om, n))
    for dtype in (torch.float32, torch.bfloat16):
        for label, x32, om32, deg in cases:
            x, om = x32.to(dtype), om32.to(dtype)
            rows, d = x.shape
            count = om.shape[0] // deg
            picked = bucket_schedule(rows, count, d, deg, x.element_size())
            if picked.kernel != "tile":
                continue
            out = torch.empty((rows, count), device="cuda")
            times = {}
            for ct in range(1, 9):
                smem = bucket_tile_smem(d, deg, ct, 2, x.element_size())
                if smem > SMEM_PER_BLOCK:
                    continue
                for runs in (1, 2, 4, 8, 16, 32):
                    sched = picked._replace(ct_per_warp=ct, runs=runs,
                                            buffers=2, smem=smem)
                    times[f"{ct}x{runs}"] = smoke.time_ms(
                        torch, lambda s=sched: _bucket_launch(
                            x, om, out, 0, deg, 1.0, s), iters=10,
                        warmup=2)
            key = f"{picked.ct_per_warp}x{picked.runs}"
            if key not in times:
                times[key] = smoke.time_ms(
                    torch, lambda: _bucket_launch(x, om, out, 0, deg, 1.0,
                                                  picked), iters=10,
                    warmup=2)
            best = min(times, key=times.get)
            print(json.dumps(dict(
                shape=label, dtype=str(dtype).split(".")[-1],
                picked=key, picked_ms=times[key], best=best,
                best_ms=times[best], ms=times)), flush=True)


if __name__ == "__main__":
    sys.exit(main())
