"""The PyTorch port stands alone: no JAX, no silent CPU fallback.

- no file of ``neuronx_distributed_tpu_torch`` (nor ``chip_smoke.py``)
  imports ``jax``, ``flax`` or ``neuronx_distributed_tpu``;
- the package and every submodule import with those modules blocked;
- without a GPU, an entry point that was not asked for the CPU raises;
- a CPU tensor routes a kernel wrapper to its plain twin, and the launch
  counter does not move.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch import _device
from neuronx_distributed_tpu_torch.inference import paged_kernel as tpk
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.kernels import flash_attn as tfa
from neuronx_distributed_tpu_torch.models import llama as tl

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "neuronx_distributed_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "neuronx_distributed_tpu"}
SUBMODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PORT.rglob("*.py") if p.name != "__init__.py")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN)
           for f in files}
    assert {f: m for f, m in bad.items() if m} == {}


def test_port_imports_with_jax_blocked():
    blocked = "; ".join(f"sys.modules[{m!r}] = None" for m in sorted(FORBIDDEN))
    code = (f"import importlib, sys; {blocked}; import neuronx_distributed_tpu_torch; "
            f"[importlib.import_module(m) for m in {SUBMODULES!r}]; print('ok')")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_overload_and_observability_modules_stand_alone():
    """The admission queue and the observability copies are stdlib-only
    ports: they are walked and imported above, and import nothing but the
    standard library."""
    for mod in ("inference.schedq", "observability.metrics", "observability.tracer"):
        assert f"neuronx_distributed_tpu_torch.{mod}" in SUBMODULES
        path = PORT.joinpath(*mod.split(".")).with_suffix(".py")
        assert set(_imported_roots(path)) <= {"__future__", "contextlib", "heapq", "json",
                                              "math", "re", "time", "collections", "typing"}


def test_fault_and_sim_modules_stand_alone():
    """The fault plan and the sim model are the port's own copies of JAX
    modules that import no JAX: the standard library, numpy and the port's
    page cache only."""
    allowed = {"__future__", "dataclasses", "json", "os", "zlib", "typing", "numpy",
               "neuronx_distributed_tpu_torch"}
    for mod in ("inference.faults", "inference.simlm"):
        assert f"neuronx_distributed_tpu_torch.{mod}" in SUBMODULES
        path = PORT.joinpath(*mod.split(".")).with_suffix(".py")
        assert set(_imported_roots(path)) <= allowed, mod
    src = (PORT / "inference" / "simlm.py").read_text()
    assert "import torch" not in src


def test_tenancy_modules_stand_alone():
    """The LoRA core, the adapter pool and the grammar compiler and pool are
    the port's own: the standard library, numpy, torch and the port only
    (the numpy compiler is a copy, not an import of the JAX package's)."""
    allowed = {"__future__", "dataclasses", "math", "re", "time", "zlib", "typing", "numpy",
               "torch", "neuronx_distributed_tpu_torch"}
    for mod in ("lora.core", "inference.adapters", "inference.grammar"):
        assert f"neuronx_distributed_tpu_torch.{mod}" in SUBMODULES
        path = PORT.joinpath(*mod.split(".")).with_suffix(".py")
        assert set(_imported_roots(path)) <= allowed, mod


def _tiny_lm_args():
    cfg = tl.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=1,
                         num_heads=4, num_kv_heads=2, max_seq_len=32, dtype=torch.float32)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, params, tl.LlamaForCausalLM


def test_entry_points_raise_without_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params, model_cls = _tiny_lm_args()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CausalLM(cfg, params, model_cls, buckets=(8,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CausalLM(cfg, params, model_cls, buckets=(8,), device="cuda")
    lm = CausalLM(cfg, params, model_cls, buckets=(8,), device="cpu")
    assert lm.device == torch.device("cpu")
    assert next(lm.model.parameters()).device.type == "cpu"


def test_cpu_tensors_take_the_twins_and_count_no_launch():
    rng = np.random.default_rng(0)
    f_before, p_before = tfa.flash_block_forward.launches, tpk.paged_decode_attention.launches
    q = torch.from_numpy(rng.standard_normal((1, 2, 64, 16), dtype=np.float32))
    out = tfa.flash_attention(q, q[:, :1], q[:, :1], block_q=64, block_k=64)
    assert out.shape == q.shape and out.device.type == "cpu"
    qd = torch.from_numpy(rng.standard_normal((2, 1, 4, 16), dtype=np.float32))
    pool = torch.from_numpy(rng.standard_normal((6, 4, 2, 16), dtype=np.float32))
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    got = tpk.paged_decode_attention(qd, pool, pool, table, torch.tensor([3, 6], dtype=torch.int32))
    want = tpk.reference_paged_attention(qd, pool, pool, table,
                                         torch.tensor([3, 6], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    assert tfa.flash_block_forward.launches == f_before
    assert tpk.paged_decode_attention.launches == p_before


def test_wrappers_refuse_tensors_off_cpu_and_cuda():
    q = torch.empty((2, 64, 16), device="meta")
    pos = torch.empty((1, 1, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="all lie on one CUDA device or all on the CPU"):
        tfa.flash_block_forward(q, q[:1], q[:1], pos, pos, 0.25, 64, 64, 2, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        _device.resolve_device("meta")


def test_chip_smoke_alone_or_without_a_gpu_fails_with_no_result(tmp_path):
    """Run outside the repository (its directory holds only the script) and,
    where no GPU is present, inside it: a nonzero exit and nothing on
    stdout."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (tmp_path,) if torch.cuda.is_available() else (tmp_path, ROOT):
        res = subprocess.run([sys.executable, str(cwd / "chip_smoke.py")], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0, res.stdout
        assert res.stdout == ""
