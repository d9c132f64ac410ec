"""The feature-sharded estimator and int8 pod compression of the port
(``repro_torch.distributed``, ``repro_torch.optim.compression``) against
the reference on the CPU, and on gloo process groups of 4 ranks.

* **Parity, four families.** ``ExponentialDotProductKernel(1.0)``, d 12, D
  1024, S 8, ``measure="proportional"`` (the reference's
  ``tests/dist_scripts/run_sharded_estimators.py`` setting): the
  reference's map handed across (``convert.sharded_from_jax``), the port's
  host-loop apply and Grams (symmetric, rectangular, ``row_chunk=7``)
  within 1e-5 of the reference's ``sharded_apply(mesh=None)`` and of its
  Gram under ``jax.vmap(axis_name="rm_features")``, where the registry's
  ``psum`` runs with no mesh; ``output_dim`` and ``truncation_bias``
  equal.
* **Gloo, 4 ranks** (one spawn of 4 processes over a ``FileStore``, no TCP
  port): each rank's own draw equals the host loop's shard s bitwise;
  the mesh apply equals the host loop
  bitwise; the mesh Gram is within 1e-5 of the host loop with exactly one
  ``all_reduce`` a Gram; the 4-fold Gram is within the reference's
  ``0.35 max |K|`` of the exact kernel.
* **Compression.** ``compressed_psum_with_feedback`` on 4 gloo ranks
  against the reference's under ``jax.vmap(axis_name="pod")``: each rank's
  ``q`` (recovered from its residual) exactly equal, the reduced grads and
  residuals within 1e-6.
"""
import json
import multiprocessing
import time

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

FAMILIES = ["rm", "tensor_sketch", "ctr", "structured"]
D_IN, D_FEAT, SHARDS = 12, 1024, 8
TOL = 1e-5            # x max(1, max |reference|): fp32 sums of 1024 terms
WORLD = 4
SPAWN_TIMEOUT = 120   # s: a hang fails the test instead of the run


def _unit_rows(n, seed):
    x = np.random.default_rng(seed).standard_normal((n, D_IN))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _gap(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def spawn(fn, world, tmp_path, *args):
    """Run ``fn(rank, world, store_path, *args)`` in ``world`` spawned
    processes; fail on a non-zero exit or past ``SPAWN_TIMEOUT``."""
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=fn, args=(r, world, store, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} ranks still running after " \
                     f"{SPAWN_TIMEOUT} s"
    assert [p.exitcode for p in procs] == [0] * world


def _init(rank, world, store):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)


# ---------------------------------------------------------------------------
# parity with the reference (one process)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_map_matches_reference(family):
    import jax

    from repro.core import ExponentialDotProductKernel as JExp
    from repro.core import registry as jreg
    from repro.distributed import estimator as jest
    from repro_torch.convert import sharded_from_jax

    jfm = jest.make_sharded_feature_map(
        JExp(1.0), D_IN, D_FEAT, jax.random.PRNGKey(3), num_shards=SHARDS,
        estimator=family, measure="proportional")
    fm = sharded_from_jax(jfm)
    assert fm.output_dim == jfm.output_dim
    assert fm.shard_output_dim == jfm.shard_output_dim
    assert fm.truncation_bias(1.0) == jfm.truncation_bias(1.0)
    x, y = _unit_rows(20, 0), _unit_rows(13, 1)
    want = jax.jit(lambda p, r: jest.sharded_apply(family, jfm.plan, p, r,
                                                   None))(jfm.params, x)
    got = fm.apply(torch.from_numpy(x))
    assert _gap(got, want) <= TOL
    assert torch.equal(fm(torch.from_numpy(x)), got)

    est = jreg.get(family)

    @jax.jit
    def vmapped(params, *rows):
        def one(p):
            return jreg.estimate_gram(
                lambda Z: est.apply(jfm.plan, p, Z, use_pallas=False),
                *rows, row_chunk=7, axis_name="rm_features") * (1.0 / SHARDS)
        return jax.vmap(one, axis_name="rm_features")(params)[0]

    for rows in ((x,), (x, y)):
        g = fm.estimate_gram(*[torch.from_numpy(r) for r in rows],
                             row_chunk=7)
        assert _gap(g, vmapped(jfm.params, *rows)) <= TOL


def test_sharded_map_arguments():
    from repro_torch.core import ExponentialDotProductKernel
    from repro_torch.distributed.estimator import make_sharded_feature_map

    kern = ExponentialDotProductKernel(1.0)
    with pytest.raises(TypeError, match="not both"):
        make_sharded_feature_map(kern, 4, 64, num_shards=2, device="cpu")
    with pytest.raises(ValueError, match="mesh= and/or num_shards="):
        make_sharded_feature_map(kern, 4, 64, seed=0, device="cpu")
    with pytest.raises(ValueError, match="divide evenly"):
        make_sharded_feature_map(kern, 4, 65, seed=0, num_shards=2,
                                 device="cpu")
    # stratified=False: the allocation seed comes from the key first
    a = make_sharded_feature_map(kern, 4, 64, seed=5, num_shards=2,
                                 stratified=False, device="cpu")
    b = make_sharded_feature_map(kern, 4, 64, seed=5, num_shards=2,
                                 stratified=False, device="cpu")
    assert 0 <= a.plan.seed < 2**31 - 1
    assert torch.equal(a.params["omegas"], b.params["omegas"])
    assert a.num_shards == 2 and a.output_dim == 2 * a.shard_output_dim


# ---------------------------------------------------------------------------
# 4 gloo ranks
# ---------------------------------------------------------------------------
def _estimator_worker(rank, world, store, out_dir, x, y):
    _init(rank, world, store)
    from repro_torch.core import ExponentialDotProductKernel
    from repro_torch.distributed import collectives
    from repro_torch.distributed.estimator import make_sharded_feature_map
    from repro_torch.launch.mesh import make_feature_mesh

    mesh = make_feature_mesh()
    kern = ExponentialDotProductKernel(1.0)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    exact = torch.exp(x @ x.T)
    report = {}
    for family in FAMILIES:
        kw = dict(seed=11, estimator=family, measure="proportional")
        host = make_sharded_feature_map(kern, D_IN, D_FEAT, num_shards=world,
                                        device="cpu", **kw)
        on_mesh = make_sharded_feature_map(kern, D_IN, D_FEAT, mesh=mesh,
                                           device="cpu", **kw)
        draws = all(torch.equal(on_mesh.params[k].to_local()[0], v[rank])
                    for k, v in host.params.items())
        z_host = host.apply(x)
        apply_equal = torch.equal(on_mesh.apply(x), z_host) and \
            torch.equal(on_mesh(x), z_host)
        grams = {}
        for label, rows in (("sym", (x,)), ("rect", (x, y))):
            before = collectives.all_reduce.calls
            g = on_mesh.estimate_gram(*rows, row_chunk=7)
            calls = collectives.all_reduce.calls - before
            g_host = host.estimate_gram(*rows, row_chunk=7)
            grams[label] = [_gap(g, g_host), calls]
        k_err = (on_mesh.estimate_gram(x) - exact).abs().max().item()
        report[family] = {"draws": draws, "apply_equal": apply_equal,
                          "grams": grams, "kernel_err": k_err,
                          "kernel_max": exact.abs().max().item(),
                          "output_dim": on_mesh.output_dim,
                          "host_output_dim": host.output_dim}
    (out_dir / f"rank{rank}.json").write_text(json.dumps(report))
    import torch.distributed as dist

    dist.destroy_process_group()


def test_sharded_estimator_on_four_gloo_ranks(tmp_path):
    x, y = _unit_rows(24, 2), _unit_rows(9, 3)
    spawn(_estimator_worker, WORLD, tmp_path, tmp_path, x, y)
    for rank in range(WORLD):
        report = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert sorted(report) == sorted(FAMILIES)
        for family, r in report.items():
            assert r["draws"], (rank, family)
            assert r["apply_equal"], (rank, family)
            assert r["output_dim"] == r["host_output_dim"]
            for label, (gap, calls) in r["grams"].items():
                assert gap <= TOL and calls == 1, (rank, family, label, gap,
                                                   calls)
            # the reference's own S-fold bound (test_distributed_estimators)
            assert r["kernel_err"] <= 0.35 * r["kernel_max"], (family, r)


def _compression_worker(rank, world, store, out_dir, grads, residuals):
    _init(rank, world, store)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compression import compressed_psum_with_feedback

    mesh = make_mesh((world,), ("pod",))
    g = {k: torch.from_numpy(v[rank]) for k, v in grads.items()}
    r = {k: torch.from_numpy(v[rank]) for k, v in residuals.items()}
    out_g, out_r = compressed_psum_with_feedback(g, r, mesh.get_group("pod"))
    np.savez(out_dir / f"comp{rank}.npz",
             **{f"g_{k}": v.numpy() for k, v in out_g.items()},
             **{f"r_{k}": v.numpy() for k, v in out_r.items()})
    import torch.distributed as dist

    dist.destroy_process_group()


def test_compressed_psum_matches_reference_on_four_gloo_ranks(tmp_path):
    import jax

    from repro.optim import compression as jcomp

    rng = np.random.default_rng(7)
    grads = {"w": rng.standard_normal((WORLD, 33, 17)).astype(np.float32),
             "b": (rng.standard_normal((WORLD, 5)) * 1e-3).astype(
                 np.float32)}
    residuals = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32)
                 for k, v in grads.items()}
    want_g, want_r = jax.vmap(
        lambda g, r: jcomp.compressed_psum_with_feedback(g, r, "pod"),
        axis_name="pod")(grads, residuals)
    spawn(_compression_worker, WORLD, tmp_path, tmp_path, grads, residuals)
    for k, g in grads.items():
        corrected = g + residuals[k]
        scale = np.float32(max(np.abs(corrected[i]).max() / np.float32(127)
                               for i in range(WORLD)))
        owner = int(np.argmax([np.abs(c).max() for c in corrected]))
        for rank in range(WORLD):
            with np.load(tmp_path / f"comp{rank}.npz") as out:
                got_g, got_r = out[f"g_{k}"], out[f"r_{k}"]
            q_got = np.rint((corrected[rank] - got_r) / scale)
            q_want = np.rint((corrected[rank] - np.asarray(want_r[k][rank]))
                             / scale)
            np.testing.assert_array_equal(q_got, q_want)
            if rank == owner:      # the shared scale is this rank's max
                assert np.abs(q_got).max() == 127
            np.testing.assert_allclose(got_g, np.asarray(want_g[k][rank]),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(got_r, np.asarray(want_r[k][rank]),
                                       rtol=0, atol=1e-6)


def test_init_distributed_world_of_one_removes_its_store(tmp_path):
    """Outside ``torchrun``, ``init_distributed`` makes a gloo world of one
    over a ``FileStore`` in a temporary directory, which is gone once the
    process exits."""
    import os
    import subprocess
    import sys

    tmp = tmp_path / "tmp"
    tmp.mkdir()
    code = (
        "import json, os, torch.distributed as dist\n"
        "from repro_torch.launch.mesh import init_distributed, "
        "make_feature_mesh\n"
        "dev = init_distributed(device='cpu')\n"
        "mesh = make_feature_mesh()\n"
        "print(json.dumps([str(dev), dist.get_backend(), "
        "dist.get_world_size(), list(mesh.shape), os.listdir(%r)]))\n"
        "dist.destroy_process_group()\n" % str(tmp))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(TMPDIR=str(tmp), PYTHONPATH=os.pathsep.join(sys.path))
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True,
                         timeout=SPAWN_TIMEOUT)
    assert run.returncode == 0, run.stderr
    dev, backend, world, shape, during = json.loads(
        run.stdout.strip().splitlines()[-1])
    assert (dev, backend, world, shape) == ("cpu", "gloo", 1, [1])
    assert len(during) == 1 and during[0].startswith("repro_torch_pg_")
    assert list(tmp.iterdir()) == []
