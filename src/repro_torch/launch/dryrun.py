"""Dry run: one rank's step of every (arch x shape) cell on the production
meshes, on ``meta`` tensors (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference lowers and compiles each cell on 512 forced host devices and
reads XLA's cost and memory analysis. PyTorch has no such lowering, so the
port runs the step itself, as rank 0 of the mesh would, on ``meta``
tensors: nothing is allocated and nothing is computed, but every operator
runs with its shapes. The pieces:

* the mesh is a ``DeviceMesh`` over PyTorch's fake process group (backend
  ``"fake"``: every collective returns at once, with no peer process) of
  256 ranks (``single``: 16 x 16 ``("data", "model")``) or 512 (``multi``:
  2 x 16 x 16 with ``"pod"``); ``one`` is a mesh of one rank;
* the params are ``models.transformer.meta_params`` cut to rank 0's
  shards (``tensor_parallel.shard_params``, over ``"data"`` too where
  ``distributed.fsdp.enabled``), the batch is rank 0's rows of
  ``launch.shapes``' specs, a decode step's cache is rank 0's slots at
  ``local_config``'s widths; the step is the Trainer's train step, or the
  serving executor's prefill or decode (its weights cut over ``"data"``
  likewise, gathered a block at a time);
* FLOPs: the formulas of ``torch.utils.flop_counter``'s registry for
  the operators it lists (matrix products, convolutions, attention;
  elementwise work is not counted), read by :class:`StepCounter`. The
  port's loops run eagerly, every trip counted, so
  ``inner_loop_flops_correction`` is 0 (the reference adds the trips XLA
  counts once). A checkpointed group's recompute is counted, as XLA
  counts the reference's rematerialized forward;
* bytes accessed, two readings (``bytes_counted_by`` says so in each
  record): ``per_device_bytes`` (``memory_s``, and so ``dominant``) the
  operands read once and the results written once of the operators
  whose FLOPs are counted (the products and attention), as if every
  elementwise operator were fused into them; ``per_device_bytes_unfused``
  (``memory_s_unfused``) every operator's, unfused (view operators move
  nothing), which no fused step moves (the reference reads XLA's bytes
  after fusion);
* collectives: the result bytes of each ``distributed.collectives`` call
  on this rank (``nbytes``), by kind; the port's reduce-scatter is an
  all-reduce and a slice, so it is counted as an all-reduce;
* memory: ``argument_size_in_bytes`` is the bytes of the tensors handed
  to the step (the train state, or the fp32 params, the batch and the
  cache); ``temp_size_in_bytes`` the peak bytes of the storages the step
  made that were alive at once (a dispatch mode holds a finalizer on each
  new storage); ``output_size_in_bytes`` those of its outputs still alive
  after it.

Records keep the reference's keys (``src/repro/launch/dryrun.py:159-186``)
where their meaning carries over: ``hlo_flops_*`` hold the counted FLOPs
(``flops_counted_by`` says so), ``meta_s`` the meta run's seconds in
place of ``lower_s`` / ``compile_s``. There is no scan to unroll and no
scanned compile, so ``unrolled`` and the ``*_scanned`` keys are gone. Each
record is written to ``results_torch/dryrun/<mesh>/<arch>__<shape>.json``
(re-runs skip existing files unless ``--force``); a cell that raises is
written as ``<arch>__<shape>.FAILED.json`` with its reason. Train cells
on ``single`` take the smallest ``grad_accum`` (up to 16) whose memory fits
the card (:func:`fits`).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.roofline import (
    COLLECTIVES,
    HW_H100,
    HardwareSpec,
    analytic_inner_loop_flops,
    count_params,
    model_flops,
    roofline_from_counts,
)
from repro_torch.common.tree import tree_bytes
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import fsdp
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import (
    batch_partition_specs,
    logical_rules_context,
    mesh_axes,
)
from repro_torch.launch.shapes import (
    SHAPES,
    ShapeSpec,
    enumerate_cells,
    prefill_batch_specs,
    train_batch_specs,
)
from repro_torch.models.transformer import (
    cast_params_to_compute,
    decode_step,
    forward,
    init_decode_cache,
    meta_params,
    prefill,
)
from repro_torch.train.steps import (
    TrainHyper,
    make_train_step,
    train_state_from_params,
)

__all__ = [
    "RESULTS_DIR",
    "MESHES",
    "UNSUPPORTED_RULES",
    "dry_world",
    "StepCounter",
    "measure",
    "measure_cell",
    "fits",
    "run_cells",
    "main",
]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results_torch" \
    / "dryrun"

# mesh name -> (shape, axes)
MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
    "one": ((1, 1), ("data", "model")),
}

# the values of each rule the port reads; a rules override outside them
# names a lever the port lacks
_EXPRESSIBLE = {
    "fsdp": (None, "data"),
    "act_seq": (None, "model", ("data",)),
    "vocab": ("model", None),
    "kv_heads": ("model", None),
    "kv_seq": (None, "model"),
}
UNSUPPORTED_RULES = {
    "kv_seq": "the KV cache's sequence cut over an axis other than 'model' "
              "(the split-K decode runs over 'model', tensor_parallel."
              "cache_cuts)",
    "act_seq": "'act_seq' over axes other than 'model' or ('data',) "
               "(tensor_parallel.sequence_sharding)",
    "kv_heads": "kv heads over an axis other than 'model'",
    "vocab": "the vocabulary over an axis other than 'model'",
    "heads": "query heads replicated or cut over another axis (the port "
             "cuts them over 'model', tensor_parallel.local_config)",
}


def _check_rules(rules) -> None:
    """Raise ``NotImplementedError`` for a rules override the port cannot
    express (it would run the baseline under the override's name)."""
    for name, value in (rules or {}).items():
        if value not in _EXPRESSIBLE.get(name, ()):
            why = UNSUPPORTED_RULES.get(
                name, f"the logical axis {name!r} mapped to {value!r}")
            raise NotImplementedError(
                f"rules override {name!r}: {value!r} is not expressible in "
                f"the port: {why}")


@contextlib.contextmanager
def dry_world(size: int):
    """A default process group of ``size`` ranks with no peers (backend
    ``"fake"``), this process rank 0, destroyed on exit.

    Raises:
        RuntimeError: a default process group exists already.
    """
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; "
                           "a default group is initialized already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts a step's FLOPs (the operators of ``torch.utils.
    flop_counter``'s registry, with its formulas: matrix products,
    convolutions, attention), the tensor inputs and outputs of those
    operators (``bytes_products``) and of every operator but views
    (``bytes_unfused``), and the peak bytes of the storages it makes that
    are alive at once."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry

        super().__init__()
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes_products = 0
        self.bytes_unfused = 0
        self.live = 0
        self.peak = 0
        self._seen = set()

    def hold(self, tree) -> None:
        """Count nothing for the storages of ``tree``'s tensors (the step's
        arguments, alive before it: a view or an in-place update of one
        makes no new storage)."""
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                self._seen.add(id(t.untyped_storage()))

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        count = self._flop_registry.get(func._overloadpacket)
        if count is None:
            # a composite operator (inference mode keeps matmul, einsum,
            # linear whole) counts through its decomposition
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not func.is_view:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            moved = sum(_nbytes(t) for t in ins + outs)
            self.bytes_unfused += moved
            if count is not None:
                self.bytes_products += moved
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


def _local_rows(batch, mesh) -> tuple:
    """Rank 0's rows of ``batch`` (the batch dim split over the mesh axes
    its spec names, as the Trainer splits it) and whether they were
    split."""
    specs = batch_partition_specs(batch, mesh)
    sizes = mesh_axes(mesh)
    out, split = {}, False
    for k, v in batch.items():
        axes = specs[k][0] if len(specs[k]) else None
        axes = () if axes is None else (axes if isinstance(axes, tuple)
                                        else (axes,))
        parts = math.prod(sizes[a] for a in axes)
        out[k] = v[:v.shape[0] // parts]
        split = split or parts > 1
    return out, split


def _collectives() -> Dict[str, Dict[str, float]]:
    return {"all-reduce": {"bytes": coll.all_reduce.nbytes,
                           "count": coll.all_reduce.calls},
            "all-gather": {"bytes": coll.all_gather.nbytes,
                           "count": coll.all_gather.calls},
            "broadcast": {"bytes": coll.broadcast.nbytes,
                          "count": coll.broadcast.calls}}


def _collective_delta(before, after) -> Dict[str, Dict[str, float]]:
    out = {k: {"bytes": 0.0, "count": 0} for k in COLLECTIVES}
    for k in after:
        out[k] = {"bytes": float(after[k]["bytes"] - before[k]["bytes"]),
                  "count": after[k]["count"] - before[k]["count"]}
    return out


def _step(cfg, spec: ShapeSpec, mesh, hyper: TrainHyper):
    """``(run, arguments)``: rank 0's step on ``mesh`` as a thunk, and the
    tensors handed to it (meta)."""
    sizes = mesh_axes(mesh)
    model = sizes.get("model", 1)
    lcfg = tp.local_config(cfg, model)
    template = meta_params(cfg)
    cut = fsdp.enabled(mesh)
    local = tp.shard_params(template, mesh, cfg, fsdp_cut=cut)
    dims = fsdp.data_dims(template, mesh) if cut else None
    b, t = spec.global_batch, spec.seq_len
    if spec.kind == "train":
        batch, split = _local_rows(train_batch_specs(cfg, t, b), mesh)
        state = train_state_from_params(local, hyper)
        groups = {f"{a}_group": mesh.get_group(a) for a in ("data", "pod")
                  if a in sizes}
        step = make_train_step(
            lcfg, hyper, cuts=tp.param_cuts(template, mesh, cfg)
            if model > 1 else None, fsdp_dims=dims, **groups)

        def run():
            with tp.local_view(mesh, batch_sharded=split):
                return step(state, batch)

        return run, {"state": state, "batch": batch}
    plan = fsdp.plan_for_mesh(mesh, dims, serving=True) if cut else None
    if spec.kind == "prefill":
        batch, split = _local_rows(prefill_batch_specs(cfg, t, b), mesh)

        def run():
            with torch.inference_mode(), \
                    tp.local_view(mesh, batch_sharded=split), \
                    fsdp.training(plan):
                params = cast_params_to_compute(local, lcfg)
                if not cfg.causal:
                    return forward(params, lcfg, batch)
                return prefill(params, lcfg, batch, t)

        return run, {"params": local, "batch": batch}
    # decode: one token a slot; the slots split over the batch axes where
    # they divide them, a MoE routing the gathered lanes (as the serving
    # executor)
    parts = math.prod(sizes.get(a, 1) for a in tp.BATCH_AXES)
    split = parts > 1 and b % parts == 0
    rows = b // parts if split else b
    cache = init_decode_cache(lcfg, rows, t, "meta")
    tokens = torch.empty((rows, 1), dtype=torch.int32, device="meta")
    positions = torch.empty((rows,), dtype=torch.int32, device="meta")

    def run():
        with torch.inference_mode(), \
                tp.local_view(mesh, batch_sharded=split,
                              gather_batch=split), \
                fsdp.training(plan):
            params = cast_params_to_compute(local, lcfg)
            return decode_step(params, lcfg, cache, tokens, positions)

    return run, {"params": local, "cache": cache,
                 "batch": {"tokens": tokens, "positions": positions}}


def measure(cfg, spec: ShapeSpec, mesh, mesh_name: str, *,
            rules: Optional[Dict[str, Any]] = None,
            hyper: Optional[TrainHyper] = None,
            hw: HardwareSpec = HW_H100, arch: Optional[str] = None
            ) -> Dict[str, Any]:
    """One rank's step of ``cfg`` at ``spec`` on ``mesh`` (a ``DeviceMesh``
    over :func:`dry_world`) under ``rules`` -> the cell's record.

    Raises:
        NotImplementedError: ``rules`` override a logical axis the port
            does not read (:data:`UNSUPPORTED_RULES`).
        ValueError: whatever the step raises.
    """
    _check_rules(rules)
    hyper = hyper or TrainHyper()
    t0 = time.perf_counter()
    with logical_rules_context(mesh, rules):
        run, arguments = _step(cfg, spec, mesh, hyper)
        before = _collectives()
        counter = StepCounter()
        counter.hold(arguments)
        with counter:
            out = run()
        colls = _collective_delta(before, _collectives())
    out_bytes = tree_bytes(list(out))
    del out
    meta_s = time.perf_counter() - t0
    arg_parts = {k: tree_bytes(v) for k, v in arguments.items()}
    memory = {
        "argument_size_in_bytes": sum(arg_parts.values()),
        "output_size_in_bytes": out_bytes,
        "temp_size_in_bytes": counter.peak,
        "alias_size_in_bytes": None,
        "generated_code_size_in_bytes": None,
        "argument_parts": arg_parts,
    }
    size = math.prod(mesh_axes(mesh).values())
    per_device = float(counter.flops)
    roof = roofline_from_counts(per_device, counter.bytes_products, colls,
                                size, hw, memory)
    n_total, n_active = count_params(
        meta_params(cfg), None if cfg.moe is None
        else cfg.moe.top_k / cfg.moe.num_experts)
    tokens = spec.global_batch * (spec.seq_len if spec.kind != "decode"
                                  else 1)
    mf = model_flops("train" if spec.kind == "train" else "serve",
                     n_active, tokens)
    global_flops = per_device * size
    return {
        "arch": arch or cfg.name,
        "shape": spec.name,
        "kind": spec.kind,
        "mesh": mesh_name,
        "mesh_shape": dict(mesh_axes(mesh)),
        "attention_mode": cfg.attention_mode,
        "seq_len": spec.seq_len,
        "global_batch": spec.global_batch,
        "tokens_per_step": tokens,
        "params_total": n_total,
        "params_active": n_active,
        "model_flops": mf,
        "hlo_flops_global": global_flops,
        "inner_loop_flops_correction": 0.0,
        "hlo_flops_corrected": global_flops,
        "compute_s_corrected": global_flops / size / hw.peak_flops,
        "useful_flops_ratio": mf / global_flops if global_flops else None,
        "flops_counted_by": "torch.utils.flop_counter's registry over "
                            "rank 0's step on meta tensors (matrix products "
                            "only; every loop trip and the remat recompute "
                            "counted; no HLO)",
        "analytic_inner_loop_flops": analytic_inner_loop_flops(
            cfg, spec.seq_len, spec.global_batch, spec.kind),
        "per_device_bytes_unfused": float(counter.bytes_unfused),
        "memory_s_unfused": counter.bytes_unfused / hw.hbm_bw,
        "bytes_counted_by": "per_device_bytes (memory_s, dominant): the "
                            "operands and results of the counted products "
                            "only, elementwise work taken as fused into "
                            "them; per_device_bytes_unfused: every "
                            "operator's, unfused",
        "collectives_note": "result bytes on rank 0; the port's "
                            "reduce-scatter is an all-reduce and a slice, "
                            "counted as all-reduce",
        "rules": {k: v for k, v in (rules or {}).items()},
        "remat": cfg.remat,
        "grad_accum": hyper.grad_accum,
        "meta_s": round(meta_s, 3),
        **roof,
    }


def fits(mem: Dict[str, Any], hw: HardwareSpec = HW_H100
         ) -> Optional[bool]:
    """Whether a step's temp and argument bytes fit 95% of the card."""
    if not mem:
        return None
    total = (mem.get("temp_size_in_bytes") or 0) + \
        (mem.get("argument_size_in_bytes") or 0)
    return bool(total < 0.95 * hw.hbm_bytes)


def _accum_start(cfg) -> int:
    n, _ = count_params(meta_params(cfg))
    return 1 if n < 4e9 else (4 if n < 2e10 else 8)


def measure_cell(cell, mesh, mesh_name: str, *, rules=None,
                 cfg_override=None, hyper: Optional[TrainHyper] = None
                 ) -> Dict[str, Any]:
    """A cell's record, the reference's protocol: on ``single``, a train
    cell takes the smallest ``grad_accum`` (from 1, 4 or 8 by the model's
    size, doubling up to 16) whose memory fits the card; other cells and
    other meshes run once. ``fits_hbm`` says whether the record's memory
    fits."""
    cfg = get_config(cell.arch, attention_mode=cell.attention_mode)
    if cfg_override is not None:
        cfg = cfg_override(cfg)
    spec = SHAPES[cell.shape]
    kw = dict(rules=rules, arch=cell.arch)
    if hyper is not None or spec.kind != "train" or mesh_name != "single":
        rec = measure(cfg, spec, mesh, mesh_name, hyper=hyper, **kw)
    else:
        accum = _accum_start(cfg)
        while True:
            rec = measure(cfg, spec, mesh, mesh_name,
                          hyper=TrainHyper(grad_accum=accum), **kw)
            if fits(rec["memory_analysis"]) or accum >= 16:
                break
            accum *= 2
    rec["fits_hbm"] = fits(rec["memory_analysis"])
    return rec


def _mesh(mesh_name: str):
    from repro_torch.launch.mesh import make_mesh

    shape, axes = MESHES[mesh_name]
    return make_mesh(shape, axes)


def run_cells(mesh_names, archs, shapes, force=False, fail_fast=False,
              out_root: Path = RESULTS_DIR):
    """Every cell of ``archs`` x ``shapes`` on each mesh -> a summary of
    ``(arch, shape, mesh, "OK" | "SKIP" | "CACHED" | "FAIL")``."""
    arch_cfgs = {a: get_config(a) for a in archs}
    cells = enumerate_cells(archs, arch_cfgs, shapes)
    summary = []
    for mesh_name in mesh_names:
        out_dir = Path(out_root) / mesh_name
        out_dir.mkdir(parents=True, exist_ok=True)
        with dry_world(math.prod(MESHES[mesh_name][0])):
            mesh = _mesh(mesh_name)
            for cell in cells:
                out_path = out_dir / f"{cell.arch}__{cell.shape}.json"
                failed = out_dir / f"{cell.arch}__{cell.shape}.FAILED.json"
                if cell.skipped:
                    rec = {"arch": cell.arch, "shape": cell.shape,
                           "mesh": mesh_name, "skipped": True,
                           "skip_reason": cell.skip_reason}
                    out_path.write_text(json.dumps(rec, indent=2))
                    summary.append((cell.arch, cell.shape, mesh_name,
                                    "SKIP"))
                    print(f"[dryrun] SKIP  {cell.arch:22s} {cell.shape:12s}"
                          f" {mesh_name}: {cell.skip_reason}", flush=True)
                    continue
                if out_path.exists() and not force:
                    summary.append((cell.arch, cell.shape, mesh_name,
                                    "CACHED"))
                    print(f"[dryrun] CACHE {cell.arch:22s} {cell.shape:12s}"
                          f" {mesh_name}", flush=True)
                    continue
                try:
                    rec = measure_cell(cell, mesh, mesh_name)
                    rec["skipped"] = False
                    out_path.write_text(json.dumps(rec, indent=2))
                    failed.unlink(missing_ok=True)
                    summary.append((cell.arch, cell.shape, mesh_name, "OK"))
                    print(f"[dryrun] OK    {cell.arch:22s} {cell.shape:12s}"
                          f" {mesh_name} meta={rec['meta_s']:.1f}s "
                          f"ga={rec['grad_accum']} fits={rec['fits_hbm']} "
                          f"dom={rec['dominant']} "
                          f"comp={rec['compute_s']:.4f}s "
                          f"mem={rec['memory_s']:.4f}s "
                          f"coll={rec['collective_s']:.4f}s", flush=True)
                except Exception as e:  # noqa: BLE001 - record failures
                    summary.append((cell.arch, cell.shape, mesh_name,
                                    "FAIL"))
                    err = {"arch": cell.arch, "shape": cell.shape,
                           "mesh": mesh_name,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()}
                    failed.write_text(json.dumps(err, indent=2))
                    print(f"[dryrun] FAIL  {cell.arch:22s} {cell.shape:12s}"
                          f" {mesh_name}: {type(e).__name__}: {e}",
                          flush=True)
                    if fail_fast:
                        raise
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Dry run of one rank's step on meta tensors over the "
                    "production meshes (results_torch/dryrun/<mesh>/).")
    ap.add_argument("--arch", default=None, help="one arch id (see configs)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="all archs x all shapes")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--fail-fast", action="store_true")
    args = ap.parse_args(argv)
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    mesh_names = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    t0 = time.perf_counter()
    summary = run_cells(mesh_names, archs, shapes, force=args.force,
                        fail_fast=args.fail_fast)
    n_ok = sum(1 for s in summary if s[3] in ("OK", "CACHED"))
    n_skip = sum(1 for s in summary if s[3] == "SKIP")
    n_fail = sum(1 for s in summary if s[3] == "FAIL")
    print(f"\n[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_fail} failed "
          f"in {time.perf_counter() - t0:.1f}s")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
