"""The port's profiler surface on the CPU (the counterparts of the
reference's ``jax_profile``, ``step_annotation`` and ``--jax-profile``):
``profile(dir)`` writes a Chrome trace of its window and nothing when
``dir`` is falsy or another capture is running; ``launch.serve --profile``
traces the engine's serving window with its dispatch and retire ranges for
every bucket served, under either driver; ``--mode lm`` serves the same with or without it; the
serving CLI takes the reference's flags, ``--jax-profile`` as ``--profile``."""
import ast
import contextlib
import io
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import serving  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import observability  # noqa: E402
from repro_torch.serving.observability import profiler  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _serve(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(argv)
    return rc, out.getvalue().splitlines()


def _trace(log_dir):
    """The one trace file in ``log_dir`` -> its event names by category."""
    (path,) = log_dir.iterdir()
    assert path.name.endswith(".pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}


def test_serving_exports_the_profiler_surface():
    for mod in (serving, observability):
        assert mod.profile is profiler.profile
        assert mod.step_annotation is profiler.step_annotation
        assert {"profile", "step_annotation"} <= set(mod.__all__)


@pytest.mark.parametrize("log_dir", [None, ""])
def test_profile_without_a_directory_records_nothing(log_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiler.profile(log_dir) as on:
        torch.ones(4).sum()
    assert on is False and not list(tmp_path.iterdir())


def test_step_annotation_names_its_range(tmp_path, capsys):
    with profiler.profile(str(tmp_path)) as on:
        with profiler.step_annotation("x", 3):
            torch.ones(4).sum()
    assert on is True
    assert "x:3" in _trace(tmp_path)
    assert f"# profile -> {next(tmp_path.iterdir())}" in capsys.readouterr().out


def test_profile_refuses_a_second_capture(tmp_path, capsys):
    inner = tmp_path / "inner"
    with profiler.profile(str(tmp_path / "outer")) as outer_on:
        with profiler.profile(str(inner)) as inner_on:
            with profiler.annotate("kept"):
                torch.ones(4).sum()
    assert outer_on is True and inner_on is False and not inner.exists()
    assert "# profile disabled (" in capsys.readouterr().out
    assert "kept" in _trace(tmp_path / "outer")


@pytest.mark.parametrize("driver", ["inline", "thread"])
def test_serve_profile_traces_every_bucket_served(driver, tmp_path):
    """Under ``--driver thread`` the engine dispatches and retires on its
    own thread: its ranges reach the trace too."""
    rc, lines = _serve(["--device", "cpu", "--mode", "ppm", "--n", "3", "--driver", driver,
                        "--profile", str(tmp_path)])
    assert rc == 0
    header = lines.index(next(ln for ln in lines if ln.startswith("request,")))
    rows = [ln.split(",") for ln in lines[header + 1:] if not ln.startswith("#")]
    assert len(rows) == 3 and all(r[4] == "ok" for r in rows)
    buckets = {r[2] for r in rows}
    names = _trace(tmp_path)
    for b in buckets:
        assert f"serve.dispatch/{b}" in names and f"serve.retire/{b}" in names
    assert {n.split("/")[0] for n in names} == {"serve.dispatch", "serve.retire"}


def test_profile_has_no_effect_in_lm_mode(tmp_path):
    argv = ["--device", "cpu", "--mode", "lm", "--n", "3", "--tokens", "4", "--window", "32"]
    log_dir = tmp_path / "prof"
    runs = [_serve(argv), _serve([*argv, "--profile", str(log_dir)])]
    assert [rc for rc, _ in runs] == [0, 0] and not log_dir.exists()
    # every column but the three timings (queue_ms, compile_ms, run_ms)
    plain, profiled = ([[c for i, c in enumerate(ln.split(",")) if i not in (5, 6, 7)]
                        for ln in lines if not ln.startswith("#")] for _, lines in runs)
    assert plain == profiled and len(plain) == 4


def test_serve_flags_are_the_references_with_profile_for_jax_profile():
    """The port's serving CLI takes every flag of the reference's, its
    ``--jax-profile`` as ``--profile``, and adds only ``--device``."""
    src = Path(__file__).resolve().parents[1] / "src" / "repro" / "launch" / "serve.py"
    ref = {n.args[0].value for n in ast.walk(ast.parse(src.read_text()))
           if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "add_argument"}
    port = {o for a in serve.parser()._actions for o in a.option_strings} - {"-h", "--help"}
    assert ref - port == {"--jax-profile"} and port - ref == {"--profile", "--device"}
