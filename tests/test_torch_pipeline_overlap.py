"""The port's GPipe schedule (``parallel/pipeline.py``), ring matmuls
(``parallel/overlap.py``) and elastic resume (``runtime/elastic.py``) on
spawned gloo ranks, against the unpipelined loss of the port and of the
JAX reference on the same numpy parameters (the reference's own cases,
``tests/test_distributed.py``).

Gates:
  * ``gpipe_loss`` on a (pod=2, data=2) mesh, 4 layers (2 a stage), 4
    microbatches: the loss within 2e-4 of ``lm.loss_fn``'s and the
    reference's on every rank; each rank's stage layers' gradients (and on
    the first stage the embedding's, final norm's and unembedding's)
    allclose 1e-5 to the unpipelined ones; 5 exchanges forward and 5 back;
  * ``ring_ag_matmul``, ``ring_ag_matmul_ws`` and ``psum_scatter_matmul``
    on 4 ranks against ``x @ w`` within 2e-4, each ring 3 shifts;
  * a checkpoint saved from a (2, 2) mesh resumed by ``resume_elastic`` on
    a (1, 2) mesh of 2 ranks: ``plan_for_devices`` gives microbatch scale
    2, and every leaf comes back bitwise, on its new placements.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))

from _torch_mesh_ranks import (_cfg, _leaf_names, elastic_resume,  # noqa: E402
                               gpipe_rings_save, run_ranks)
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.bridge import lm_params_from_numpy  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

N_MICRO = 4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    jcfg = jax_reduce_config(jax_get_config("qwen1.5-0.5b")).replace(
        dtype="float32", layers=4, tie_embeddings=False)
    tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0), jcfg))
    jcfg2 = jax_reduce_config(jax_get_config("qwen1.5-0.5b")).replace(dtype="float32")
    tree2 = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0), jcfg2))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (8, 16)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab, (8, 16)).astype(np.int32)}
    xw = (rng.standard_normal((16, 64)).astype(np.float32),
          rng.standard_normal((64, 32)).astype(np.float32))
    d = str(tmp_path_factory.mktemp("elastic"))
    ranks = run_ranks(4, gpipe_rings_save, tree, batch, xw, N_MICRO, tree2, d)
    resumed = run_ranks(2, elastic_resume, tree2, d)
    yield {"jcfg": jcfg, "tree": tree, "tree2": tree2, "batch": batch, "xw": xw,
           "ranks": ranks, "resumed": resumed}
    torch.set_num_threads(prev)


def test_gpipe_loss_matches_unpipelined_and_reference(setup):
    cfg = _cfg("qwen1.5-0.5b").replace(layers=4, tie_embeddings=False)
    params = lm_params_from_numpy(setup["tree"], cfg, device="cpu")
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    loss = lm.loss_fn(params, batch, cfg, remat=False)
    grads = dict(zip(_leaf_names(params), torch.autograd.grad(loss, flat)))
    want = float(jlm.loss_fn(jax.tree.map(jnp.asarray, setup["tree"]),
                             {k: jnp.asarray(v) for k, v in setup["batch"].items()},
                             setup["jcfg"], remat=False))
    for r, out in enumerate(setup["ranks"]):
        np.testing.assert_allclose(out["loss"], float(loss.detach()), rtol=2e-4)
        np.testing.assert_allclose(out["loss"], want, rtol=2e-4)
        stage = r // 2
        own = {n for n in grads if n.startswith(tuple(
            f"blocks.{i}." for i in range(2 * stage, 2 * stage + 2)))}
        if r == 0:
            own |= {n for n in grads if not n.startswith("blocks.")}
        assert set(out["grads"]) == own
        for n in own:
            np.testing.assert_allclose(out["grads"][n], grads[n].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=n)
        assert out["permutes"] == 2 * (N_MICRO + 2 - 1)


@pytest.mark.parametrize("op", ("ring_ag", "ring_ws", "psum_scatter"))
def test_ring_matmuls_match_dense(setup, op):
    x, w = setup["xw"]
    want = x @ w
    for r, out in enumerate(setup["ranks"]):
        exp = want[r * 4:(r + 1) * 4] if op == "psum_scatter" else want
        np.testing.assert_allclose(out[op], exp, rtol=2e-4, atol=2e-4)
        # two rings of 3 shifts; the weight's blocks gathered once; one reduce-scatter
        assert out["ring_counts"] == {"all_gather": 1, "permute": 6, "reduce_scatter": 1}


def test_elastic_resume_onto_a_smaller_mesh_bitwise(setup):
    cfg = _cfg("qwen1.5-0.5b")
    want = leaves(lm_params_from_numpy(setup["tree2"], cfg, device="cpu"))
    saved = setup["ranks"][0]["saved"]
    assert saved[1] == "(Replicate(), Shard(dim=1))"        # embed over model at 2 x 2
    for r in setup["resumed"]:
        assert r["step"] == 42 and r["scale"] == 2 and r["mesh"] == (1, 2)
        assert len(r["leaves"]) == len(want)
        for a, b in zip(r["leaves"], want):
            assert np.array_equal(a, b.numpy())
        assert r["placements"][:3] == ["(Replicate(), Replicate())",
                                       "(Replicate(), Shard(dim=1))",
                                       "(Replicate(), Shard(dim=0))"]
