"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of ``repro``, and the port's entry points
refuse to fall back to the CPU quietly when there is no GPU."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import device as device_mod

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


def test_every_module_imports_with_jax_blocked():
    mods = _port_modules()
    assert "repro_torch.kernels.coo_spmm" in mods
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; import importlib; "
            f"[importlib.import_module(m) for m in {mods!r}]; "
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None)")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_database_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")
    from repro_torch.core import engine, ir
    schema = ir.Schema()
    schema.declare("V", ("id",), "bool")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.Database(schema, {"id": 3}, {"V": torch.ones(3).bool()})
    with pytest.raises(RuntimeError):
        device_mod.resolve(None)
    with pytest.raises(RuntimeError):
        device_mod.resolve("cuda")
    db = engine.Database(schema, {"id": 3}, {"V": torch.ones(3).bool()},
                         "cpu")
    assert db.device == torch.device("cpu")
    assert db.with_relations({}).device == db.device


def test_kernel_wrappers_take_plain_version_only_on_cpu(monkeypatch):
    """A CPU tensor goes to the plain version; any other device goes to
    the CUDA launcher, never to the plain version."""
    from repro_torch.kernels import coo_segment
    seen = []
    monkeypatch.setattr(coo_segment, "segment_reduce_cuda",
                        lambda *a: seen.append("cuda"))
    monkeypatch.setattr(coo_segment, "segment_reduce_plain",
                        lambda *a: seen.append("plain"))
    v = torch.ones(3)
    ids = torch.zeros(3, dtype=torch.int32)
    coo_segment.segment_reduce("nat", v, ids, 2)
    coo_segment.segment_reduce("nat", v.to("meta"), ids.to("meta"), 2)
    assert seen == ["plain", "cuda"]


def test_kernel_build_is_lazy():
    """Importing the port builds and loads nothing: the library is made
    on the first launch, from the sources' hash."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch.core.program, repro_torch.kernels.ops; "
            "from repro_torch.kernels import cuda_lib; "
            "assert cuda_lib.library.cache_info().currsize == 0; "
            "assert 'ctypes' not in sys.modules or "
            "cuda_lib.library.cache_info().misses == 0")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    from repro_torch.kernels import cuda_lib
    assert cuda_lib.library_path().name.startswith("librepro_torch_")
    assert all((cuda_lib.CSRC / s).exists() for s in cuda_lib.SOURCES)
