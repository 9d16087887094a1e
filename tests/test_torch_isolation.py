"""The PyTorch port stands alone: no JAX, no silent CPU fallback.

- no file of ``neuronx_distributed_tpu_torch`` (nor ``chip_smoke.py``)
  imports ``jax``, ``flax`` or ``neuronx_distributed_tpu``, nor loads a
  module of the JAX package by path (``spec_from_file_location`` and the
  like), and no code string of the port names the JAX package;
- the package and every submodule import with those modules blocked;
- without a GPU, an entry point that was not asked for the CPU raises;
- a CPU tensor routes a kernel wrapper to its plain twin, and the launch
  counter does not move.
"""

import ast
import os
import re
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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's default pool would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


JAX_PACKAGE_PATH = re.compile(r"neuronx_distributed_tpu(?!_torch)")
PATH_LOADERS = {"spec_from_file_location", "SourceFileLoader", "SourcelessFileLoader",
                "run_path", "load_source", "import_module", "__import__"}


def _call_name(func) -> str:
    return func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", "")


def _jax_package_loads(source: str, in_package: bool):
    """(line, text) of each place the source reaches the JAX package other
    than by an import statement: a module loaded by path or by name
    (``spec_from_file_location``, ``run_path``, ``import_module``, ...) or a
    path joined (``/``, ``os.path.join``, ``Path(...)``) with an argument
    naming it; in a file of the port package, any string of its code
    (docstrings aside) that names it."""
    tree = ast.parse(source)
    docs = {id(n.value) for n in ast.walk(tree)
            if isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant)}

    def naming(node):
        return [(c.lineno, c.value) for c in ast.walk(node)
                if isinstance(c, ast.Constant) and isinstance(c.value, str)
                and id(c) not in docs and JAX_PACKAGE_PATH.search(c.value)]

    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _call_name(node.func) in PATH_LOADERS | {"join", "Path"}:
            found.update(naming(node))
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            found.update(naming(node))
    if in_package:
        found.update(naming(tree))
    return sorted(found)


def test_no_port_file_loads_the_jax_package_by_path():
    """Beyond imports: no port file, script or ``chip_smoke.py`` loads a JAX
    module by path (as JAX's own ``scripts/nxdcheck.py`` loads
    ``neuronx_distributed_tpu/analysis``), and the detector catches exactly
    that load when it is planted."""
    files = ([(f, True) for f in sorted(PORT.rglob("*.py"))]
             + [(ROOT / "chip_smoke.py", False), (ROOT / "scripts" / "nxdcheck_torch.py", False)])
    found = {str(f.relative_to(ROOT)): _jax_package_loads(f.read_text(), pkg) for f, pkg in files}
    assert {f: hits for f, hits in found.items() if hits} == {}
    planted = ('"""Loads the JAX checker."""\n'
               "import importlib.util\n"
               "spec = importlib.util.spec_from_file_location(\n"
               "    'nxd_analysis', ROOT / 'neuronx_distributed_tpu' / 'analysis' / '__init__.py')\n")
    assert _jax_package_loads(planted, in_package=False) == [(4, "neuronx_distributed_tpu")]
    assert _jax_package_loads("X = 'neuronx_distributed_tpu/analysis'\n", in_package=True) == [
        (1, "neuronx_distributed_tpu/analysis")]


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
    allowed = {"__future__", "dataclasses", "math", "os", "re", "time", "zlib", "typing",
               "numpy", "torch", "neuronx_distributed_tpu_torch"}
    for mod in ("lora.core", "inference.adapters", "inference.grammar"):
        assert f"neuronx_distributed_tpu_torch.{mod}" in SUBMODULES
        path = PORT.joinpath(*mod.split(".")).with_suffix(".py")
        assert set(_imported_roots(path)) <= allowed, mod


def test_distributed_training_modules_stand_alone():
    """The distributed-training line (bootstrap, seeds, partitioning, head
    padding, ZeRO-1, its converter and the Llama-2 example) is the port's
    own: the standard library, numpy, torch and the port only."""
    allowed = {"__future__", "argparse", "dataclasses", "datetime", "glob", "os", "typing",
               "numpy", "torch", "neuronx_distributed_tpu_torch"}
    for mod in ("parallel.distributed", "parallel.random", "parallel.partitioning",
                "parallel.pad", "parallel.loss", "parallel.grads", "optimizer.zero1",
                "optimizer.convert_zero_checkpoints", "examples.llama2_tp_zero1"):
        assert f"neuronx_distributed_tpu_torch.{mod}" in SUBMODULES
        path = PORT.joinpath(*mod.split(".")).with_suffix(".py")
        assert set(_imported_roots(path)) <= allowed, mod


def test_parallel_core_modules_stand_alone():
    """The rank layout and launchers, the TP regions and the serving specs
    are the port's own: the standard library, numpy, torch and the port
    only."""
    allowed = {"__future__", "atexit", "dataclasses", "datetime", "os", "re", "threading",
               "typing", "numpy", "torch", "neuronx_distributed_tpu_torch"}
    for mod in ("parallel.mesh", "parallel.mappings", "inference.partition"):
        assert f"neuronx_distributed_tpu_torch.{mod}" in SUBMODULES
        path = PORT.joinpath(*mod.split(".")).with_suffix(".py")
        assert set(_imported_roots(path)) <= allowed, mod


def test_cp_and_pp_modules_stand_alone():
    """Ring attention, the pipeline schedules and engine, the pipelined
    Llama, the CP microbench, the TP x PP example and the script that runs
    phase 4m alone: none imports ``jax`` or the JAX package (the schedules
    are the port's own copy of a pure-logic JAX module); the schedules
    import the standard library only."""
    mods = ("ops.ring_attention", "pipeline.schedules", "pipeline.engine",
            "models.llama_pipeline", "utils.cp_microbench", "examples.llama2_tp_pp")
    for mod in mods:
        assert f"neuronx_distributed_tpu_torch.{mod}" in SUBMODULES
        path = PORT.joinpath(*mod.split(".")).with_suffix(".py")
        assert not set(_imported_roots(path)) & FORBIDDEN, mod
    assert set(_imported_roots(PORT / "pipeline" / "schedules.py")) <= {
        "__future__", "dataclasses", "typing"}
    script = ROOT / "scripts" / "cp_pp_phase.py"
    assert not set(_imported_roots(script)) & FORBIDDEN


def test_a_bound_local_rank_picks_its_card(monkeypatch):
    """A process-per-rank launch binds its local rank: the default device
    is ``cuda:{local_rank}``, made current; a rank with no card of its own
    raises; an explicit device is taken as it is; without a GPU it raises
    as before."""
    picked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    try:
        _device.bind_local_rank(1)
        assert _device.resolve_device() == torch.device("cuda:1")
        assert picked == [torch.device("cuda:1")]
        assert _device.resolve_device("cpu") == torch.device("cpu")
        assert _device.resolve_device("cuda:0") == torch.device("cuda:0")
        _device.bind_local_rank(2)
        with pytest.raises(RuntimeError, match="local rank 2 has no card"):
            _device.resolve_device()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _device.resolve_device()
    finally:
        _device.bind_local_rank(None)
    assert picked == [torch.device("cuda:1")]


def test_gloo_group_refuses_captured_programs_on_cuda(monkeypatch):
    """A gloo group's collectives cannot run inside a CUDA graph: a
    ``CausalLM`` on the card with one raises unless the caller asks for
    ``capture_programs=False``, and its fused block raises (the caller
    serves with ``fused=False``). Nothing falls back on its own."""
    from neuronx_distributed_tpu_torch.parallel import mesh

    cfg, params, model_cls = _tiny_lm_args()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def rank(r):
        g = mesh.get_tensor_model_parallel_group()
        lm = CausalLM(cfg, params, model_cls, buckets=(8,), device="cpu", tp_group=g)
        lm.device = torch.device("cuda")   # the checks read only the device's kind
        with pytest.raises(ValueError, match="capture_programs=False"):
            lm._check_capturable()
        with pytest.raises(ValueError, match="fused=False"):
            lm.compile_session_decode_fused(4)
        lm.capture_programs = False
        lm._check_capturable()
        return lm.tp

    assert mesh.run_in_threads(1, rank) == [1]


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


def test_program_and_speculation_entry_points_need_the_gpu_or_the_cpu(monkeypatch):
    """``ModelBuilder.trace``, ``medusa_generate`` and speculation (through
    the ``CausalLM`` s it takes) raise without a GPU unless asked for the
    CPU, and run there when asked."""
    from neuronx_distributed_tpu_torch.inference.medusa import medusa_generate
    from neuronx_distributed_tpu_torch.inference.model_builder import ModelBuilder
    from neuronx_distributed_tpu_torch.inference.speculative import speculative_generate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mb = ModelBuilder().add("f", lambda x: x + 1, (torch.zeros(3),))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mb.trace()
    assert torch.equal(mb.trace(device="cpu").run("f", torch.ones(2)), torch.tensor([2., 2., 1.]))
    cfg, params, model_cls = _tiny_lm_args()
    heads = {f"medusa_{kind}_0.{leaf}": torch.zeros(shape) for kind, leaf, shape in (
        ("res", "kernel", (32, 32)), ("res", "bias", (32,)), ("head", "kernel", (32, 64)))}
    ids = np.arange(1, 6, dtype=np.int32)[None]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        medusa_generate(cfg, {**params, **heads}, ids, 2, num_medusa_heads=1,
                        medusa_choices=[(0,)])
    assert medusa_generate(cfg, {**params, **heads}, ids, 2, num_medusa_heads=1,
                           medusa_choices=[(0,)], device="cpu").tokens.shape == (1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CausalLM(cfg, params, model_cls, buckets=(8,), max_batch=1)
    t, d = (CausalLM(cfg, params, model_cls, buckets=(8,), max_batch=1, device="cpu")
            for _ in range(2))
    assert speculative_generate(t, d, ids, 3, num_draft=2).stats["acceptance_rate"] == 1.0


def test_program_modules_stand_alone():
    """The model builder, speculation and Medusa are the port's own: the
    standard library, numpy, torch and the port only (the safetensors format
    is written and read here, with no package for it)."""
    allowed = {"__future__", "dataclasses", "json", "os", "struct", "time", "typing",
               "numpy", "torch", "neuronx_distributed_tpu_torch"}
    for mod in ("inference.model_builder", "inference.speculative", "inference.medusa"):
        assert f"neuronx_distributed_tpu_torch.{mod}" in SUBMODULES
        path = PORT.joinpath(*mod.split(".")).with_suffix(".py")
        assert set(_imported_roots(path)) <= allowed, mod


def test_quantization_and_moe_modules_stand_alone():
    """Int8 serving and the Mixtral family are the port's own: the standard
    library, torch and the port only."""
    allowed = {"__future__", "collections", "contextlib", "dataclasses", "math", "re",
               "typing", "torch", "neuronx_distributed_tpu_torch"}
    for mod in ("quantization.core", "kernels.w8a16", "moe.routing", "moe.expert_mlps",
                "moe.layer", "models.mixtral"):
        assert f"neuronx_distributed_tpu_torch.{mod}" in SUBMODULES
        path = PORT.joinpath(*mod.split(".")).with_suffix(".py")
        assert set(_imported_roots(path)) <= allowed, mod


def test_expert_parallel_training_stands_alone():
    """The expert-parallel training line (the Mixtral example, the MoE
    modules, the parallel core it extends) and the script that runs phase
    4n alone import neither JAX nor the JAX package, and the script needs
    a GPU: without one it exits 1 and prints no result."""
    files = [PORT / "examples" / "mixtral_moe.py", ROOT / "scripts" / "moe_phase.py"] + [
        PORT.joinpath(*m.split(".")).with_suffix(".py")
        for m in ("moe.routing", "moe.expert_mlps", "moe.layer", "models.mixtral",
                  "parallel.mesh", "parallel.mappings", "optimizer.zero1", "parallel.grads",
                  "trainer.step", "trainer.model")]
    for f in files:
        assert f.exists(), f
        assert not set(_imported_roots(f)) & FORBIDDEN, f
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, str(ROOT / "scripts" / "moe_phase.py")], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1 and "no CUDA device" in res.stderr
    assert '"ok"' not in res.stdout


def test_fleet_modules_stand_alone():
    """The router, disaggregation and the autoscaler are the port's own: the
    standard library, numpy and the port only (the autoscaler and the
    router's queue the standard library alone); none imports ``jax`` or
    the JAX package, not even the reference's host-only modules."""
    allowed = {"__future__", "collections", "dataclasses", "heapq", "time", "typing", "numpy",
               "neuronx_distributed_tpu_torch"}
    for mod, extra in (("inference.router", set()), ("inference.disagg", set()),
                       ("inference.autoscale", set()), ("inference.schedq", set())):
        assert f"neuronx_distributed_tpu_torch.{mod}" in SUBMODULES
        path = PORT.joinpath(*mod.split(".")).with_suffix(".py")
        assert set(_imported_roots(path)) <= allowed | extra, mod
    for mod in ("inference.autoscale", "inference.schedq"):
        path = PORT.joinpath(*mod.split(".")).with_suffix(".py")
        assert set(_imported_roots(path)) <= {"__future__", "dataclasses", "heapq", "typing"}


def test_fleet_entry_points_need_the_gpu_or_the_cpu(monkeypatch):
    """A fleet runs where its ``CausalLM`` runs: with no GPU the model
    refuses to build on CUDA, and a CPU model's replicas, handoffs and
    spawned sessions all stay on the CPU (nothing moves quietly)."""
    from neuronx_distributed_tpu_torch.inference.disagg import DisaggRouter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params, model_cls = _tiny_lm_args()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CausalLM(cfg, params, model_cls, buckets=(8,), page_size=4)
    lm = CausalLM(cfg, params, model_cls, buckets=(8,), page_size=4, max_batch=2, device="cpu")
    router = DisaggRouter(lm, 2, prefill_replicas=1, block_steps=2)
    router.submit(np.arange(1, 7, dtype=np.int32), 4)
    router.run()
    assert router.stats["handoffs_adopted"] == 1 and len(router.completed) == 1
    assert all(e.session.state.cache.keys[0].device.type == "cpu" for e in router.engines)


def test_int8_mixtral_needs_the_gpu_or_the_cpu_and_cpu_tensors_take_b5s_twin(monkeypatch):
    """A Mixtral ``CausalLM`` on an int8 dict raises without a GPU unless
    asked for the CPU; there every int8 product runs B5's twin and counts no
    launch."""
    from neuronx_distributed_tpu_torch.kernels.w8a16 import w8a16_gemm
    from neuronx_distributed_tpu_torch.models import mixtral as tm
    from neuronx_distributed_tpu_torch.quantization.core import QuantizationConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tm.MixtralConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=1,
                           num_heads=4, num_kv_heads=2, max_seq_len=32, num_experts=4,
                           dtype=torch.float32)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            model_cls=tm.MixtralForCausalLM, quantize=QuantizationConfig())
    assert params["model.layers.0.moe.experts.gate.qweight"].dtype == torch.int8
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CausalLM(cfg, params, tm.MixtralForCausalLM, buckets=(8,), max_batch=1)
    before = w8a16_gemm.launches
    lm = CausalLM(cfg, params, tm.MixtralForCausalLM, buckets=(8,), max_batch=1, device="cpu")
    out = lm.generate(np.arange(1, 6, dtype=np.int32)[None], 3)
    assert out.tokens.shape == (1, 3) and w8a16_gemm.launches == before
