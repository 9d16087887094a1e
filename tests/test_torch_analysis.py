"""The port's nxdcheck (``neuronx_distributed_tpu_torch.analysis``):

(a) on JAX's fixture trees its determinism, resource-pairing and
    surface-drift rules and its waiver machinery give exactly JAX's
    findings;
(b) on the torch fixture corpus (``tests/fixtures/nxdcheck_torch``) every
    rule fires on ``bad`` with the defect classes pinned below and stays
    silent on ``good``;
(c) every rule fires on a fault planted in a copy of the port's own file;
(d) the real port tree has zero unwaived findings, and every waiver has a
    reason and waives no zero-waiver rule;
(e) the CLI keeps the protocol (exit 0/1/2, the JSON summary last, the six
    ids) with ``jax`` and ``torch`` poisoned on ``PYTHONPATH``.

The real tree is swept once, by the CLI, in a module fixture. Literals a
test of the port must not hold (stats keys, event names) live in the
fixture files only: JAX's checker reads every top-level test file.
"""

import ast
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from neuronx_distributed_tpu_torch.analysis import ALL_RULES, RULES_BY_ID, run_checks

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "neuronx_distributed_tpu_torch"
CLI = ROOT / "scripts" / "nxdcheck_torch.py"
TORCH_FIXTURES = ROOT / "tests" / "fixtures" / "nxdcheck_torch"
JAX_FIXTURES = ROOT / "tests" / "fixtures" / "nxdcheck"
RULE_IDS = ("host-sync", "cache-replication", "resource-pairing", "determinism",
            "surface-drift", "async-contract")
JAX_HEADLINE = {"bench": "bench.py", "regress": "scripts/bench_regress.py",
                "artifacts": "BENCH_r*.json"}
TORCH_HEADLINE = {"bench": "bench.py", "regress": "scripts/bench_regress.py",
                  "artifacts": "artifacts/run_*.json"}


def _poisoned_env(tmp_path, *extra_path):
    """A PYTHONPATH whose ``jax`` and ``torch`` raise at import: the CLI
    passing under it shows that it imports neither."""
    shim = tmp_path / "shim"
    shim.mkdir(exist_ok=True)
    for mod in ("jax", "torch"):
        (shim / f"{mod}.py").write_text(f"raise ImportError('nxdcheck must not import {mod}')\n")
    return {**os.environ, "PYTHONPATH": os.pathsep.join([str(shim), *map(str, extra_path)])}


def _cli(tmp_path, *args, module=False):
    cmd = ([sys.executable, "-m", "neuronx_distributed_tpu_torch.analysis"] if module
           else [sys.executable, str(CLI)])
    return subprocess.run(cmd + list(args), capture_output=True, text=True, cwd=ROOT,
                          env=_poisoned_env(tmp_path, ROOT), timeout=120)


@pytest.fixture(scope="module")
def port_sweep(tmp_path_factory):
    """The one sweep of the real port tree: the CLI with ``--json``."""
    proc = _cli(tmp_path_factory.mktemp("sweep"), "--json")
    lines = proc.stdout.strip().splitlines()
    summary = json.loads(lines[-1])
    findings = json.loads("\n".join(lines[:-1]))["findings"]
    print(f"port sweep: {summary['elapsed_s']} s, {len(findings)} findings")
    return proc, summary, findings


def _keys(findings):
    return {(f.rule, f.path, f.line, f.qualname) for f in findings}


# --------------------------------------------------------------------------
# (a) parity with JAX on its fixture trees
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rule_id", ("determinism", "resource-pairing", "surface-drift"))
def test_rule_equals_jax_on_jax_fixtures(rule_id):
    from neuronx_distributed_tpu import analysis as jax_analysis

    for tree in ("bad", "good"):
        root = JAX_FIXTURES / tree
        want = _keys(jax_analysis.run_checks(root, (jax_analysis.RULES_BY_ID[rule_id],)))
        got = _keys(run_checks(root, (RULES_BY_ID[rule_id],), package="neuronx_distributed_tpu",
                               headline=JAX_HEADLINE))
        assert got == want, (tree, got ^ want)
        assert bool(want) == (tree == "bad")


WAIVER_CASES = {
    "inline": ("import time\n"
               "def decide():\n"
               "    # nxdcheck: waive determinism -- fixture justification\n"
               "    return time.time()\n", None),
    "file": ("import time\n"
             "def decide():\n"
             "    return time.time()\n",
             "determinism neuronx_distributed_tpu/mod.py decide -- fixture file waiver\n"),
    "empty_reason": ("import time\n"
                     "def decide():\n"
                     "    return time.time()  # nxdcheck: waive determinism\n", None),
    "unknown_rule": ("import time\n"
                     "def decide():\n"
                     "    return time.time()  # nxdcheck: waive no-such-rule -- why\n", None),
    "zero_waiver": ("class ServeEngine:\n"
                    "    def _release_adapter(self, req):\n"
                    "        self._adapter_pins.pop(req.request_id, None)\n"
                    "    def _release_grammar(self, req):\n"
                    "        self._grammar_pins.pop(req.request_id, None)\n"
                    "    # nxdcheck: waive resource-pairing -- cannot waive this\n"
                    "    def cancel(self, req):\n"
                    "        self._out.pop(req.request_id, None)\n"
                    "        self._release_adapter(req)\n", None),
}


@pytest.mark.parametrize("case", sorted(WAIVER_CASES))
def test_waiver_machinery_equals_jax(tmp_path, case):
    from neuronx_distributed_tpu import analysis as jax_analysis

    source, waiver_line = WAIVER_CASES[case]
    pkg = tmp_path / "neuronx_distributed_tpu"
    name = "inference/engine.py" if case == "zero_waiver" else "mod.py"
    (pkg / name).parent.mkdir(parents=True)
    (pkg / name).write_text(source)
    wf = None
    if waiver_line is not None:
        wf = tmp_path / "waivers.txt"
        wf.write_text(waiver_line)
    ids = ("determinism", "resource-pairing", "surface-drift")
    want = jax_analysis.run_checks(tmp_path, [jax_analysis.RULES_BY_ID[r] for r in ids],
                                   waiver_file=wf)
    got = run_checks(tmp_path, [RULES_BY_ID[r] for r in ids], waiver_file=wf,
                     package="neuronx_distributed_tpu")
    assert [(f.rule, f.path, f.line, f.qualname, f.waived, f.waiver_reason) for f in got] == \
        [(f.rule, f.path, f.line, f.qualname, f.waived, f.waiver_reason) for f in want]
    gating = {f.rule for f in got if not f.waived}
    assert gating == {"inline": set(), "file": set(), "empty_reason": {"waiver"},
                      "unknown_rule": {"waiver", "determinism"},
                      "zero_waiver": {"waiver"}}[case]
    if waiver_line is not None:
        wf.write_text("this is not a valid waiver line\n")
        with pytest.raises(ValueError):
            run_checks(tmp_path, [RULES_BY_ID["determinism"]], waiver_file=wf,
                       package="neuronx_distributed_tpu")


# --------------------------------------------------------------------------
# (b) the torch fixture corpus
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_fires_on_bad_and_stays_silent_on_good(rule_id):
    rule = (RULES_BY_ID[rule_id],)
    bad = run_checks(TORCH_FIXTURES / "bad", rule, headline=TORCH_HEADLINE)
    assert bad and {f.rule for f in bad} == {rule_id}
    good = run_checks(TORCH_FIXTURES / "good", rule, headline=TORCH_HEADLINE)
    assert good == [], "\n".join(f"{f.path}:{f.line} {f.message}" for f in good)


def test_bad_fixture_finding_shapes():
    """The defect classes the corpus encodes, each pinned by file and by a
    piece of its message (JAX's classes, in the port's idiom)."""
    findings = run_checks(TORCH_FIXTURES / "bad", ALL_RULES, headline=TORCH_HEADLINE)
    got = {(f.rule, f.path.split("/")[-1]) for f in findings}
    assert got >= {
        ("host-sync", "captured.py"), ("cache-replication", "captured.py"),
        ("resource-pairing", "engine.py"), ("determinism", "sched.py"),
        ("surface-drift", "bench.py"), ("surface-drift", "faults.py"),
        ("surface-drift", "test_torch_surface.py"), ("surface-drift", "run_01.json"),
        ("async-contract", "async_loop.py"),
    }
    quals = {(f.rule, f.qualname) for f in findings}
    assert {("host-sync", "FusedDecode._note"), ("host-sync", "build_decode.body"),
            ("host-sync", "capture_by_hand"), ("resource-pairing", "ServeEngine._complete"),
            ("cache-replication", "Runner.fetch")} <= quals
    assert ("cache-replication", "Runner.safe") not in quals
    msgs = " | ".join(f.message for f in findings)
    for needle in (".item()", ".cpu()", ".tolist()", "torch.cuda.synchronize()", "np.asarray()",
                   ".to('cpu')", "print()", "int() coercion", "branch on a device value",
                   "iteration over a device value",
                   "returns a graph's static output", "stores a graph's static output",
                   "returns self.buf",
                   "never releases the ['grammar']", "['adapter', 'grammar']", "storm",
                   "*_pins map",
                   "wall-clock", "unseeded", "torch.rand() draws from torch's global generator",
                   ".normal_() draws", "reseeds", "bare-set iteration",
                   "dead_knob_prob", "ghost_key", "ghost_event", "ghost_ratio",
                   "serve_thing_ms", "no producing store", "retired_key",
                   "pipelined dispatch path", "harvest helpers", "time.sleep()"):
        assert needle in msgs, f"missing defect class: {needle}"


def test_headline_checks_run_only_when_named():
    """Without a named bench the port reads no bench surface: the bad
    root's headline defects go silent and its other drift stays."""
    findings = run_checks(TORCH_FIXTURES / "bad", (RULES_BY_ID["surface-drift"],))
    files = {f.path.split("/")[-1] for f in findings}
    assert files == {"faults.py", "test_torch_surface.py"}


# --------------------------------------------------------------------------
# (c) faults planted in copies of the port's own files
# --------------------------------------------------------------------------

PLANTS = {
    "resource-pairing": (
        "inference/engine.py",
        "            self.queue.remove(r.request_id)\n            self._release_pins(r.request_id)\n",
        "            self.queue.remove(r.request_id)\n",
        "ServeEngine.extract_queued"),
    "host-sync": (
        "inference/causal_lm.py",
        '        done = f("done") != 0\n',
        '        done = f("done") != 0\n        if done.any():\n            done = done | active\n',
        "FusedDecode._body"),
    "async-contract": (
        "inference/engine.py",
        "        self.replays += 1\n        self.program_calls += 1\n",
        "        self.replays += 1\n        self.program_calls += 1\n        out.cpu()\n",
        "ServeEngine._dispatch_block_async"),
    "determinism": (
        "inference/sampling.py",
        "torch.rand(shape, generator=generator, dtype=torch.float32",
        "torch.rand(shape, dtype=torch.float32",
        "gumbel_noise"),
    "cache-replication": (
        "inference/model_builder.py",
        "        return _clone_out(self.replay())\n",
        "        return self.replay()\n",
        "CapturedProgram.__call__"),
    "surface-drift": (
        "inference/faults.py",
        "    park_corrupt_prob: float = 0.0\n",
        "    park_corrupt_prob: float = 0.0\n    ghost_drop_prob: float = 0.0\n",
        "FaultPlan"),
}


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_fires_on_a_fault_planted_in_the_ports_own_file(tmp_path, rule_id):
    sub, anchor, planted, qualname = PLANTS[rule_id]
    source = (PORT / sub).read_text()
    assert source.count(anchor) == 1, "the plant's anchor moved"
    copy = tmp_path / "neuronx_distributed_tpu_torch" / sub
    copy.parent.mkdir(parents=True)
    rule = (RULES_BY_ID[rule_id],)

    def sweep(text):
        copy.write_text(text)
        return {(f.rule, f.path, f.qualname, f.message)
                for f in run_checks(tmp_path, rule) if not f.waived}

    new = sweep(source.replace(anchor, planted)) - sweep(source)
    assert new, f"{rule_id} stayed silent on its planted fault"
    assert {(r, p, q) for r, p, q, _ in new} == {
        (rule_id, f"neuronx_distributed_tpu_torch/{sub}", qualname)}
    if rule_id == "surface-drift":
        assert all("ghost_drop_prob" in m for *_, m in new)


# --------------------------------------------------------------------------
# (d) the real port tree
# --------------------------------------------------------------------------

def test_port_tree_has_zero_unwaived_findings(port_sweep):
    _, summary, findings = port_sweep
    unwaived = [f for f in findings if not f["waived"]]
    assert unwaived == [], "\n".join(
        f"{f['rule']} {f['path']}:{f['line']} {f['qualname']}: {f['message']}"
        for f in unwaived)
    assert summary["unwaived"] == 0 and summary["verdict"] == "clean"


def test_port_waivers_carry_reasons_and_spare_zero_waiver_rules(port_sweep):
    _, _, findings = port_sweep
    waived = [f for f in findings if f["waived"]]
    for f in waived:
        assert f["waiver_reason"], f"{f['path']}:{f['line']} waived without a reason"
        assert not RULES_BY_ID[f["rule"]].zero_waiver, f
    assert {(f["rule"], f["path"], f["qualname"]) for f in waived} == {
        ("determinism", "neuronx_distributed_tpu_torch/checkpoint/storage.py", "_retry")}


def test_every_completion_leaves_unpinned():
    """Every completion releases the request's adapter and grammar pins
    (JAX's ``_completion_of`` does); before, ``ServeEngine._complete`` left
    the release to each caller (resource-pairing's finding on the port)."""
    from neuronx_distributed_tpu_torch.inference.engine import Completion, ServeEngine
    from neuronx_distributed_tpu_torch.inference.simlm import SimCausalLM

    eng = ServeEngine(SimCausalLM(max_batch=2, buckets=(8,)), block_steps=2)
    released = []
    eng.session.adapters = eng.session.grammars = types.SimpleNamespace(
        release=released.append)
    rid = 7
    eng._adapter_pins[rid], eng._grammar_pins[rid] = "a", "g"
    eng._out[rid], eng._out_ts[rid] = [3, 4], [0.0, 0.0]
    eng._complete(Completion(request_id=rid, tokens=np.zeros((0,), np.int64), prompt_len=2,
                             queue_blocks=0, decode_blocks=1), eng.blocks)
    assert rid not in eng._adapter_pins and rid not in eng._grammar_pins
    assert released == ["a", "g"]
    assert eng.completed[-1].tokens.tolist() == [3, 4]


# --------------------------------------------------------------------------
# (e) the CLI
# --------------------------------------------------------------------------

def test_cli_clean_tree_exit0_without_jax_or_torch(port_sweep):
    proc, summary, _ = port_sweep
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert summary["verdict"] == "clean" and summary["unwaived"] == 0
    assert tuple(summary["rules"]) == RULE_IDS
    assert set(summary) == {"rules", "findings", "unwaived", "waived", "by_rule",
                            "elapsed_s", "verdict"}


def test_cli_findings_exit1_on_the_bad_fixture(tmp_path):
    proc = _cli(tmp_path, "--root", str(TORCH_FIXTURES / "bad"), "--json")
    assert proc.returncode == 1, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["verdict"] == "findings" and summary["unwaived"] > 0
    assert set(summary["by_rule"]) == set(RULE_IDS)
    full = json.loads("\n".join(lines[:-1]))
    assert {f["rule"] for f in full["findings"]} == set(RULE_IDS)
    assert "[FINDING]" in proc.stderr


@pytest.mark.parametrize("args", (("--rules", "no-such-rule"), ("--no-such-flag",)))
def test_cli_usage_errors_exit2(tmp_path, args):
    assert _cli(tmp_path, *args).returncode == 2


def test_cli_module_form_lists_the_six_rules(tmp_path):
    proc = _cli(tmp_path, "--list", module=True)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"rules": list(RULE_IDS)}
    assert "headline" in proc.stdout and "[zero-waiver]" in proc.stdout


def test_cli_exit2_on_an_unparsable_package_file(tmp_path):
    pkg = tmp_path / "repo" / "neuronx_distributed_tpu_torch"
    pkg.mkdir(parents=True)
    (pkg / "broken.py").write_text("def f(:\n")
    assert _cli(tmp_path, "--root", str(tmp_path / "repo")).returncode == 2


def test_analysis_package_is_stdlib_only():
    allowed = {"__future__", "argparse", "ast", "dataclasses", "fnmatch", "io", "json", "re",
               "sys", "time", "tokenize", "pathlib", "typing"}
    for p in sorted((PORT / "analysis").glob("*.py")):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                assert {a.name.split(".")[0] for a in node.names} <= allowed, p.name
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                assert node.module.split(".")[0] in allowed, p.name
