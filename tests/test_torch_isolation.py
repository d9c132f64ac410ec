"""The port stands alone: no file of src/repro_torch/, chip_smoke.py or
time_rm_kernels.py imports jax or the reference package, its entry points default to the CUDA
device and refuse to run on the CPU unless asked, and chip_smoke.py prints
no result and fails where there is no card (or no repository)."""
import ast
import inspect
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "time_rm_kernels.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


SUBPACKAGES = ("sketch", "ctr", "structured", "core", "models", "serve",
               "data", "launch", "kernels", "paper", "obs", "bench",
               "common", "train")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_imports_first_in_a_fresh_process(sub):
    """Each subpackage of the port imports on its own, first in a fresh
    interpreter (no import cycle through the registry), and the registry
    then lists the four families, each entry built once."""
    code = (f"import repro_torch.{sub}\n"
            "from repro_torch.core import registry\n"
            "names = registry.list_estimators()\n"
            "assert names == ('ctr', 'rm', 'structured', 'tensor_sketch')\n"
            "assert all(registry.get(n) is registry.get(n) for n in names)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


def test_port_sources_exist():
    assert len(PORT_FILES) > 20
    assert (ROOT / "src" / "repro_torch" / "csrc" / "rm_feature.cu").exists()
    for name in ("rm_fused_attention.cu", "rm_attention_chunked.cu",
                 "tensor_sketch.cu", "rm_fused_state.cu",
                 "rm_fused_apply.cu", "ctr_feature.cu",
                 "structured_feature.cu", "rm_feature_bucket.cu"):
        assert (ROOT / "src" / "repro_torch" / "csrc" / name).exists()


def test_package_turns_tf32_off():
    import repro_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_make_engine_targets_cuda_and_refuses_cpu_fallback():
    from repro_torch.launch.serve import make_engine
    from repro_torch.serve import Scheduler

    assert inspect.signature(make_engine).parameters["device"].default \
        == "cuda"
    assert inspect.signature(Scheduler).parameters["device"].default \
        == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_engine("qwen3-1.7b")


def _run_smoke(cwd, env_extra=None):
    import os

    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
