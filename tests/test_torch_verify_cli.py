"""scripts/port_verify.py end to end: the twin of tests/test_verify_cli.py
for the port's front (the self-clean gate, the JSON artifact, the model leg,
the baseline-update round trip), then what the port's front adds: it runs
with jax, ggrs_tpu and torch blocked, it probes the port's built libraries,
and its hygiene gate covers the port's build directory."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import ggrs_tpu_torch._build as tbuild

REPO = Path(__file__).resolve().parents[1]
CLI = REPO / "scripts/port_verify.py"


def run_cli(*args, env=None):
    return subprocess.run(
        [sys.executable, str(CLI), *args],
        capture_output=True, text=True, cwd=REPO, timeout=120, env=env,
    )


def _front():
    spec = importlib.util.spec_from_file_location("port_verify_front", CLI)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestVerifyCli:
    def test_tree_passes_baseline_aware(self):
        proc = run_cli()
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "port-verify: PASS" in proc.stdout
        # the committed legacy findings are reported, not fatal
        assert "FAIL " not in proc.stdout
        assert proc.stdout.count("legacy ggrs_tpu_torch/broadcast/journal.py:") == 2

    def test_json_artifact(self, tmp_path):
        out = tmp_path / "verify.json"
        proc = run_cli("--json", str(out))
        assert proc.returncode == 0, proc.stdout + proc.stderr
        verdict = json.loads(out.read_text())
        assert verdict["verdict"] == "PASS"
        assert verdict["new"] == []
        assert set(verdict["counts"]) == {
            "layout", "determinism", "ownership", "transitions",
            "hygiene",
        }
        assert "models" not in verdict  # only --model embeds the leg

    def test_quick_mode_passes(self):
        proc = run_cli("--quick")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "port-verify: PASS" in proc.stdout
        assert "model leg:" not in proc.stdout
        assert "runtime probe:" not in proc.stdout

    def test_model_leg_and_trace_artifact(self, tmp_path):
        out = tmp_path / "verify.json"
        proc = run_cli("--model", "--no-runtime", "--json", str(out))
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "model leg: 18 models," in proc.stdout
        assert "invariant(expected)" in proc.stdout
        verdict = json.loads(out.read_text())
        assert verdict["counts"]["model"] == 0
        models = {m["model"]: m for m in verdict["models"]}
        assert len(models) == 18
        fix = models["checkpoint-order:pre-pr11"]
        assert [s["action"] for s in fix["trace"][1:]] == [
            "advance_rollback", "checkpoint", "crash_failover",
        ]
        assert models["watchdog:head"]["kind"] == "clean"
        assert "probes" not in verdict  # --no-runtime

    def test_bad_model_budget_is_a_tool_error(self):
        proc = run_cli("--model", "--model-budget", "lots")
        assert proc.returncode == 2
        assert "bad --model-budget" in proc.stderr

    def test_empty_baseline_fails_on_legacy_findings(self, tmp_path):
        blank = tmp_path / "blank.json"
        blank.write_text('{"version": 2, "files": {}}\n')
        proc = run_cli("--baseline", str(blank))
        assert json.loads(
            (REPO / "ggrs_tpu_torch/analysis/determinism_baseline.json").read_text()
        )["files"]
        assert proc.returncode == 1, proc.stdout
        assert "FAIL ggrs_tpu_torch/broadcast/journal.py:" in proc.stdout

    def test_baseline_update_roundtrip(self, tmp_path):
        scratch = tmp_path / "scratch.json"
        proc = run_cli("--baseline", str(scratch), "--baseline-update")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert scratch.exists()
        # the regenerated baseline is the committed one, byte for byte
        assert scratch.read_text() == (
            REPO / "ggrs_tpu_torch/analysis/determinism_baseline.json").read_text()
        proc = run_cli("--baseline", str(scratch))
        assert proc.returncode == 0, proc.stdout + proc.stderr


class TestPortFront:
    def test_runs_with_jax_ggrs_tpu_and_torch_blocked(self, tmp_path):
        blocker = tmp_path / "blocked"
        for name in ("jax", "ggrs_tpu", "torch"):
            (blocker / name).mkdir(parents=True)
            (blocker / name / "__init__.py").write_text(
                f"raise ImportError('{name} is blocked in this process')\n")
        env = dict({k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                   PYTHONPATH=str(blocker))
        out = tmp_path / "verify.json"
        proc = run_cli("--model", "--json", str(out), env=env)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "port-verify: PASS" in proc.stdout and "is blocked" not in proc.stderr
        verdict = json.loads(out.read_text())
        assert verdict["verdict"] == "PASS" and len(verdict["models"]) == 18

    def test_host_library_probe_runs_on_the_production_build(self, tmp_path, monkeypatch):
        tbuild.build_host("")
        # a sanitizer variable in the environment must not steer the probe
        # onto a sanitized library
        env = dict(os.environ, GGRS_NATIVE_SANITIZE="1")
        out = tmp_path / "verify.json"
        proc = run_cli("--json", str(out), env=env)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        probes = json.loads(out.read_text())["probes"]
        assert probes["host"] == tbuild.host_library_path("").relative_to(REPO).as_posix()
        digest = tbuild.library_path("digest")
        assert probes["digest"] == (
            digest.relative_to(REPO).as_posix() if digest.exists() else None)
        assert f"runtime probe: host library {probes['host']}" in proc.stdout

    def test_probe_findings_when_a_stride_drifts(self, monkeypatch):
        tbuild.build_host("")
        front = _front()
        analysis = front._load_analysis()
        probed = {}
        assert front.check_runtime_probes(analysis, probed) == []
        monkeypatch.setattr(analysis.layout, "LAYOUT_REQ_STRIDE", 32)
        found = front.check_runtime_probes(analysis, {})
        assert [(f.rule, f.detail) for f in found] == [
            ("layout/runtime-probe", "ggrs_bank_req_stride() = 24 != static contract 32")]

    def test_hygiene_requires_the_port_build_dir_ignored(self, tmp_path, monkeypatch):
        front = _front()
        analysis = front._load_analysis()
        assert front.check_hygiene(analysis) == []
        subprocess.run(["git", "init", "-q", str(tmp_path)], check=True)
        rules = (REPO / ".gitignore").read_text().replace("ggrs_tpu_torch/_build/\n", "")
        (tmp_path / ".gitignore").write_text(rules)
        monkeypatch.setattr(front, "REPO", tmp_path)
        found = front.check_hygiene(analysis)
        assert [(f.rule, f.detail) for f in found] == [
            ("hygiene/gitignore", "missing ignore rule 'ggrs_tpu_torch/_build/'")]
