"""The port's sequential fold server on the CPU, its serving decisions
against the JAX reference (bitwise: framework-free arithmetic), the import
isolation of ``repro_torch`` and ``chip_smoke.py``, and ``chip_smoke.py``'s
refusal to run without a card."""
import ast
import contextlib
import io
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import ProteinSampler as JaxSampler  # noqa: E402
from repro.serving.scheduler import bucket_for as jax_bucket_for  # noqa: E402
from repro.serving.scheduler import parse_buckets as jax_parse_buckets  # noqa: E402
from repro.serving.scheduler import pow2_buckets as jax_pow2_buckets  # noqa: E402
from repro.serving.types import pad_to_bucket as jax_pad_to_bucket  # noqa: E402
from repro_torch.data.pipeline import AA_VOCAB, ProteinSampler  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import (bucket_for, pad_to_bucket, parse_buckets,  # noqa: E402
                                 pow2_buckets)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's default of a
    thread per core in each of them oversubscribes the CPU many times."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


@pytest.mark.parametrize("seed,min_len,max_len", [(11, 24, 64), (0, 64, 2048), (11, 64, 256)])
def test_protein_sampler_bitwise(seed, min_len, max_len):
    mine, ref = ProteinSampler(seed, min_len, max_len), JaxSampler(seed, min_len, max_len)
    for i in range(6):
        np.testing.assert_array_equal(mine.sample(i), ref.sample(i))
    np.testing.assert_array_equal(mine.batch(2, 3, 17), ref.batch(2, 3, 17))
    assert AA_VOCAB == 21


def test_bucket_decisions_match_reference():
    for lo, hi in ((24, 64), (1, 16), (64, 256), (100, 3000), (17, 17)):
        assert pow2_buckets(lo, hi) == jax_pow2_buckets(lo, hi)
        assert parse_buckets("pow2", lo, hi) == jax_parse_buckets("pow2", lo, hi)
    for spec in ("96,192,256", "256, 96,192", "32"):
        assert parse_buckets(spec, 1, 2) == jax_parse_buckets(spec, 1, 2)
    with pytest.raises(ValueError):
        parse_buckets(" , ", 1, 2)
    buckets = (96, 192, 256)
    for n in (1, 95, 96, 97, 192, 200, 256, 257, 1000):
        assert bucket_for(buckets, n) == jax_bucket_for(buckets, n)


def test_pad_to_bucket_matches_reference():
    seqs = [np.arange(5, dtype=np.int32), np.arange(9, dtype=np.int32) % 21]
    for batch in (None, 4):
        a, m = pad_to_bucket(seqs, 12, batch)
        ja, jm = jax_pad_to_bucket(seqs, 12, batch)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(m, jm)
    with pytest.raises(ValueError):
        pad_to_bucket(seqs, 8)
    with pytest.raises(ValueError):
        pad_to_bucket(seqs, 12, batch=1)


def _serve(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(argv)
    return rc, out.getvalue().splitlines()


@pytest.mark.parametrize("kernels,label", [("auto", "auto:ref"), ("kernel", "kernel-plain")])
def test_sequential_server_on_cpu(kernels, label):
    argv = ["--mode", "ppm", "--no-engine", "--device", "cpu", "--n", "3",
            "--min-len", "24", "--max-len", "64", "--buckets", "32,48", "--kernels", kernels]
    rc, lines = _serve(argv)
    assert rc == 0
    assert lines[0] == serve.CSV_HEADER
    rows = [ln.split(",") for ln in lines[1:]]
    assert len(rows) == 3
    sampler = JaxSampler(seed=11, min_len=24, max_len=64)
    for i, row in enumerate(rows):
        n = len(sampler.sample(i))
        bucket = jax_bucket_for((32, 48), n)
        assert int(row[0]) == i and int(row[1]) == n
        if bucket is None:
            assert row[3] == "rejected:too-long"
            continue
        assert int(row[2]) == bucket
        assert float(row[3]) > 0
        assert 0.5 < float(row[4]) <= 1.0 + 1e-6        # TM of lightnobel_aaq vs fp
        assert row[5] == label


def test_serve_function_returns_finite_coords():
    from repro_torch.configs import reduce_ppm_config
    from repro_torch.models.ppm import init_ppm
    cfg = reduce_ppm_config()
    params = init_ppm(cfg, seed=0, device="cpu")
    seqs = [ProteinSampler(seed=11).sample(0, length=20), np.zeros(70, np.int32)]
    lines = []
    res = serve.serve_ppm_sequential(cfg, params, seqs, (32, 64), scheme="baseline_fp16",
                                     fidelity=False, device="cpu", emit=lines.append)
    assert res[0].bucket == 32 and res[0].coords.shape == (20, 3)
    assert torch.isfinite(res[0].coords).all() and res[0].tm_vs_fp is None
    assert res[1].bucket is None and lines[-1] == "1,70,,rejected:too-long,,"


def test_server_refuses_engine_mode_and_missing_card():
    """The engine mode (the default) serves when the CPU is asked for, and
    refuses to start without a card, as the sequential mode does."""
    rc, lines = _serve(["--mode", "ppm", "--device", "cpu", "--n", "2", "--buckets", "32,64"])
    assert rc == 0 and lines[0].startswith("request,len,bucket,batch,status")
    assert [ln.split(",")[4] for ln in lines[1:3]] == ["ok", "ok"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["--no-engine"], []):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--mode", "ppm", "--n", "1", *argv])


# --------------------------------------------------------------------------
# import isolation: no JAX, nothing of the JAX package, not its benchmarks
# --------------------------------------------------------------------------
_ISOLATION = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
missing = {"repro_torch.serving.observability.profiler", "repro_torch.examples.train_lm",
           "repro_torch.examples.lm_serve_quantized_kv"} - set(names)
assert not missing, missing
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro", "benchmarks")
             or m.startswith(("jax.", "jaxlib", "repro.", "benchmarks.")))
print(len(names), bad)
assert not bad, bad
"""


def test_repro_torch_imports_neither_jax_nor_repro():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", _ISOLATION], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 25


def _imported_roots(path):
    tree = ast.parse(Path(path).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_and_port_sources_import_no_jax():
    banned = {"jax", "jaxlib", "repro", "benchmarks"}
    for script in ("chip_smoke.py", "chip_diag.py"):
        roots = _imported_roots(ROOT / script)
        assert "repro_torch" in roots and not roots & banned, script
    for py in (SRC / "repro_torch").rglob("*.py"):
        assert not _imported_roots(py) & banned, py


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    # alone in a directory, without the rest of the repository
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
