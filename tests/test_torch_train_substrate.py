"""CPU tests of the port's checkpointing, fault-tolerant driver and
training launcher, each held to the behaviour of the reference's test
(``tests/test_substrate.py``): round trip, retention, no temporary left
behind, async saves, a checkpoint the reference wrote restored into the
port's parameters bitwise, a resumed run equal to an uninterrupted one
(the counter driver, and reduced qwen1.5-0.5b on one torch thread,
bitwise), the straggler watch, and the launcher's flags."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpointing as jckpt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint import checkpointing as ckpt  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.fault_tolerance import (DriverConfig, StragglerWatch,  # noqa: E402
                                                 TrainingDriver)
from repro_torch.tree import leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 4), generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32)},
            "step": torch.tensor(3, dtype=torch.int32),
            "layers": [{"g": torch.randn(3, generator=g)}, {"g": torch.randn(3, generator=g)}]}


def _equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# --------------------------------------------------------------------------
# checkpointing
# --------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 12, tree)
    step, restored = ckpt.restore(str(tmp_path), _tree(seed=1))
    assert step == 12
    _equal(restored, tree)
    assert list(restored) == list(tree)


def test_checkpoint_retention_and_latest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, _tree(), keep_last_k=2)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000004", "step_00000005"]
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), _tree())


def test_checkpoint_no_tmp_left_behind(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_async_checkpointer(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    tree = _tree(1)
    before = tree["w"].clone()
    saver.save_async(7, tree)
    tree["w"].add_(1.0)                  # the snapshot was taken before this
    saver.wait()
    step, restored = ckpt.restore(str(tmp_path), _tree())
    assert step == 7 and torch.equal(restored["w"], before)
    (rec,) = saver.records
    assert rec["step"] == 7 and rec["bytes"] == sum(t.numel() * t.element_size()
                                                   for t in leaves(tree))


def test_checkpoint_refuses_a_mismatched_template(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(8, 4)})
    bad = _tree()
    bad["w"] = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), bad)


def test_reference_checkpoint_restores_into_the_port_bitwise(tmp_path):
    """The reference's ``checkpointing.save`` of whisper-base's (reduced)
    parameters and AdamW state after one update (its layers are lists on
    both sides) restores into the port's own fresh parameters and
    optimizer state, leaf for leaf, bitwise; and the port's save of them
    restores into the reference's template."""
    jcfg = jax_reduce_config(jax_get_config("whisper-base")).replace(dtype="float32")
    tcfg = reduce_config(get_config("whisper-base")).replace(dtype="float32")
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    jo = jadamw.init(jp)
    jp, jo, _ = jadamw.update(jp, jax.tree.map(lambda a: a * 0.5 + 0.1, jp), jo,
                              jadamw.AdamWConfig(lr=0.1))
    jckpt.save(str(tmp_path / "ref"), 3, (jp, jo))
    tp = lm.init_params(torch.Generator().manual_seed(0), tcfg)
    step, (rp, ro) = ckpt.restore(str(tmp_path / "ref"), (tp, adamw.init(tp)), cfg=tcfg)
    assert step == 3 and int(ro["step"]) == 1 and ro["step"].dtype == torch.int32
    want = jax.tree.leaves((jp, jo))
    got = leaves((rp, ro))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ckpt.save(str(tmp_path / "port"), 4, (rp, ro), cfg=tcfg)
    step, back = jckpt.restore(str(tmp_path / "port"), (jp, jo))
    assert step == 4
    for g, w in zip(jax.tree.leaves(back), want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _port_layout(tree, cfg):
    """The reference's (params, AdamW state) in the port's layout (the
    bridge unstacks ``blocks``/``periods``), as CPU tensors."""
    from repro_torch.bridge import lm_params_from_numpy
    p, o = jax.tree.map(np.asarray, tree)
    conv = lambda t: lm_params_from_numpy(t, cfg, device="cpu")  # noqa: E731
    return conv(p), {"m": conv(o["m"]), "v": conv(o["v"]),
                     "step": torch.from_numpy(np.array(o["step"]))}


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-v2-lite-16b", "recurrentgemma-9b"])
def test_stacked_layer_checkpoints_cross_both_ways_bitwise(tmp_path, arch):
    """Configs whose layers the reference stacks on a leading axis (qwen's
    and deepseek's ``blocks`` under ``scan_layers``, deepseek's dense
    ``first_block`` apart; recurrentgemma's ``periods``): the reference's
    save of its parameters and AdamW state after one update restores into
    the port's fresh per-layer lists bitwise (against the bridge's
    unstacking), and the port's save of them restores into the
    reference's template bitwise, with the reference's leaf count."""
    jcfg = jax_reduce_config(jax_get_config(arch)).replace(dtype="float32")
    tcfg = reduce_config(get_config(arch)).replace(dtype="float32")
    assert tcfg.scan_layers == jcfg.scan_layers
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    jo = jadamw.init(jp)
    jp, jo, _ = jadamw.update(jp, jax.tree.map(lambda a: a * 0.5 + 0.1, jp), jo,
                              jadamw.AdamWConfig(lr=0.1))
    jckpt.save(str(tmp_path / "ref"), 3, (jp, jo))
    tp = lm.init_params(torch.Generator().manual_seed(1), tcfg)
    template = (tp, adamw.init(tp))
    with pytest.raises(ValueError, match="leaves|shape"):   # the layout is the config's
        ckpt.restore(str(tmp_path / "ref"), template)
    step, got = ckpt.restore(str(tmp_path / "ref"), template, cfg=tcfg)
    assert step == 3
    want = _port_layout((jp, jo), tcfg)
    _equal(got, want)
    ckpt.save(str(tmp_path / "port"), 4, got, cfg=tcfg)
    step, back = jckpt.restore(str(tmp_path / "port"), (jp, jo))
    assert step == 4
    ref = jax.tree.leaves((jp, jo))
    assert len(leaves(ckpt.stack_layers(got, tcfg))) == len(ref)
    for g, w in zip(jax.tree.leaves(back), ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# --------------------------------------------------------------------------
# fault tolerance
# --------------------------------------------------------------------------
def _counter_driver(tmp_path, fail_at=None, total=20):
    def step_fn(state, step):
        return {"x": state["x"] + step}, {"x": float(state["x"])}

    cfg = DriverConfig(total_steps=total, ckpt_every=5, ckpt_dir=str(tmp_path),
                       fail_at_step=fail_at)
    return TrainingDriver(cfg, step_fn, lambda: {"x": torch.zeros((), dtype=torch.int32)})


def test_driver_resume_equals_uninterrupted(tmp_path):
    clean = _counter_driver(tmp_path / "clean")
    s1 = clean.run()
    failed = _counter_driver(tmp_path / "failed", fail_at=13)
    s2 = failed.run()
    assert failed.restarts == 1 and failed.starts == [0, 10]
    assert int(s1["x"]) == int(s2["x"]) == sum(range(20))


def test_straggler_watch_flags_outlier():
    w = StragglerWatch(window=16, z_threshold=4.0)
    for i in range(20):
        w.observe(i, 0.1 + 0.001 * (i % 3))
    assert not w.flagged
    assert w.observe(20, 5.0)
    assert w.flagged == [20]


_ARGV = ["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "8", "--batch", "4", "--seq", "16",
         "--ckpt-every", "3", "--aaq-ste", "--device", "cpu"]


def test_launcher_resume_equals_uninterrupted_bitwise(tmp_path, capsys):
    """Reduced qwen1.5-0.5b under ``--aaq-ste``, 8 steps with a failure at
    step 5 (restart from the step-2 checkpoint) against 8 uninterrupted
    steps: the final parameters and optimizer state bitwise equal (one
    torch thread), the losses of the replayed steps equal."""
    clean = train.main(_ARGV + ["--ckpt-dir", str(tmp_path / "clean")])
    failed = train.main(_ARGV + ["--ckpt-dir", str(tmp_path / "failed"), "--fail-at", "5"])
    assert failed.driver.restarts == 1 and failed.driver.starts == [0, 3]
    assert len(clean.losses) == 8 and len(failed.losses) == 5 + 5
    assert failed.losses[5:] == clean.losses[3:]
    _equal(failed.state, clean.state)
    assert clean.losses[-1] < clean.losses[0]
    assert [r["step"] for r in failed.driver.saves] == [2, 5]
    out = capsys.readouterr().out
    assert "restarts=1 stragglers=" in out and "done: 10 steps" in out


def test_launcher_refuses_model_parallel_naming_item_11(monkeypatch):
    """Item 11.1 ported ``--model-parallel``: on the card it takes one rank a
    card, so more ranks than cards are refused before anything starts (the
    sharded run itself: ``test_torch_train_mesh.py``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices"):
        train.main(["--model-parallel", "2"])


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--reduced", "--steps", "1"])


def test_launcher_cli_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --reduced`` as a
    user runs it, with gradient compression and 2 microbatches."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                        "--reduced", "--steps", "3", "--batch", "4", "--seq", "16",
                        "--microbatches", "2", "--grad-compress", "--ckpt-every", "2",
                        "--ckpt-dir", str(tmp_path / "ck")],
                       capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("done: 3 steps") and "restarts=0" in r.stdout
    assert ckpt.latest_step(str(tmp_path / "ck")) == 1
