"""The port's examples (``python -m repro_torch.examples.<name>``) run on
the CPU with ``--device cpu``, each exiting 0 after its own assertions
(the counterparts of the reference's ``examples/quickstart.py`` and
``examples/fold_server.py``)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(name: str) -> list[str]:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}", "--device",
                          "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
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
