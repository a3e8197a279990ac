"""The port's examples (``python -m repro_torch.examples.<name>``) run on
the CPU with ``--device cpu``, each exiting 0 after its own assertions
(the counterparts of the reference's ``examples/quickstart.py``,
``fold_server.py``, ``train_lm.py`` and ``lm_serve_quantized_kv.py``);
the LM example's KV bytes are the reference's, and its drift gate fails
when the tolerance is 0."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.core.schemes import make_scheme as jmake_scheme
from repro.serving.lm import LMKVAdmission as JLMKVAdmission

ROOT = Path(__file__).resolve().parents[1]


def _run(name: str, *args: str, rc: int = 0) -> list[str]:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}", "--device",
                          "cpu", *args], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == rc, out.stdout + out.stderr
    return out.stdout.splitlines()


def test_quickstart_folds_with_and_without_aaq():
    lines = _run("quickstart")
    tm = float(next(ln for ln in lines if ln.startswith("TM-score")).split("=")[1].split()[0])
    assert 0.99 <= tm <= 1.0
    assert any("2.09x smaller" in ln for ln in lines)
    assert [ln.split("Group ")[1][0] for ln in lines if "-> Group" in ln] == ["A", "B", "C"]
    _plain_on_the_cpu(lines[-1])


def _plain_on_the_cpu(line: str) -> None:
    """The last line's counts: on the CPU no kernel launched."""
    assert line.startswith("# launches ")
    launches, plain = line.removeprefix("# launches ").split(" plain ")
    assert set(json.loads(launches).values()) == {0} and json.loads(plain)


@pytest.fixture(scope="module")
def fold_server_lines():
    return _run("fold_server")


@pytest.mark.parametrize("act", ["in_process", "http"])
def test_fold_server_runs_both_acts(act, fold_server_lines):
    lines = fold_server_lines
    if act == "in_process":
        assert any(ln.startswith("# tails ms: queue_wait p50=") for ln in lines)
        assert "# steady-state wave: new_compiles=0" in lines
        assert sum(ln.split(",")[4:5] == ["ok"] for ln in lines) == 6
    else:
        http = next(ln for ln in lines if ln.startswith("# http fold "))
        assert "tm_vs_act_one=1.000000" in http and "replicas_healthy=1" in http
        assert "bitwise_vs_act_one=True" in http            # one thread on the CPU
        _plain_on_the_cpu(lines[-1])


def test_train_lm_loss_falls_through_the_preemption():
    # 40 steps: the first 20 or so sit deep in the 100-step learning-rate
    # warm-up, where the loss moves less than batch to batch
    lines = _run("train_lm", "--steps", "40")
    done = next(ln for ln in lines if ln.startswith("done: "))
    first, last = map(float, re.search(r"loss ([0-9.]+) -> ([0-9.]+)", done).groups())
    assert last < first and "restarts=1" in done
    assert "training example OK: loss decreased through a simulated preemption" in lines
    _plain_on_the_cpu(lines[-1])


def _kv_bytes(scheme: str) -> int:
    """The reference's ``admission.bytes_per_request`` at the example's
    config and window."""
    cfg = jreduce_config(jget_config("qwen1.5-0.5b")).replace(dtype="float32")
    return JLMKVAdmission(cfg, jmake_scheme(scheme), 64).bytes_per_request


@pytest.mark.parametrize("tol", ["default", "zero"])
def test_lm_serve_quantized_kv_bytes_and_drift_gate(tol):
    lines = _run("lm_serve_quantized_kv", *(["--drift-tol", "0"] if tol == "zero" else []),
                 rc=0 if tol == "default" else 1)
    fp16, aaq = _kv_bytes("baseline_fp16"), _kv_bytes("lightnobel_aaq")
    assert f"kv_bytes_per_request fp16={fp16} aaq={aaq} ratio={fp16 / aaq:.2f}x" in lines
    drift = float(next(ln for ln in lines if ln.startswith("max |logits_first")).split()[5])
    assert sum(ln.split(",")[3:4] == ["ok"] for ln in lines) == 12
    if tol == "default":
        assert 0 < drift <= 0.25 and "OK" in lines
    else:
        assert drift > 0 and any(ln.startswith("FAIL: quantized-KV drift") for ln in lines)
    _plain_on_the_cpu(lines[-1])
