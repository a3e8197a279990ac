"""The training half of the port's sharding rules
(``repro_torch/parallel/sharding.py``) and ``runtime/elastic.py``'s plan,
against the JAX reference's live answers, in process (no rank is started).

Gates:
  * ``param_spec`` for every leaf of all ten configs at full size, on an
    abstract 16 x 16 mesh and on (2, 4): the port's path (layers a list,
    ``blocks.3.attn.q.w``) against the reference's stacked path with its
    leading layer ``None`` dropped, entry for entry;
  * the reference's own rule cases (``tests/test_analysis_and_sharding.py``);
  * ``batch_specs``, ``cache_specs`` (all five cache layouts, also against
    the structure of the port's ``make_cache``), ``default_act_rules`` and
    ``opt_state_shardings`` entry for entry;
  * ``plan_for_devices`` on a grid of device counts;
  * the ``P`` -> DTensor placements conversion.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce_config  # noqa: E402
from repro.configs.base import LM_SHAPES as JAX_LM_SHAPES  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.runtime.elastic import plan_for_devices as jax_plan  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config, reduce_config  # noqa: E402
from repro_torch.configs.base import LM_SHAPES  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.runtime.elastic import plan_for_devices  # noqa: E402

MESHES = ((16, 16), (2, 4))


def _jmesh(shape):
    try:
        return jax.sharding.AbstractMesh(shape, ("data", "model"))
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(("data", "model"), shape)))


def _p(spec) -> sh.P:
    """A reference ``PartitionSpec`` as the port's ``P``."""
    return sh.P(*spec)


def _unstack(tree):
    """The reference's shape tree in the port's layout: ``blocks`` and
    ``periods`` stacked for ``scan`` become lists of layers (leaves lose
    the leading axis), as ``bridge.lm_params_from_numpy`` does."""
    def drop(t):
        if isinstance(t, dict):
            return {k: drop(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [drop(v) for v in t]
        return types.SimpleNamespace(shape=tuple(t.shape[1:]))

    def keep(t):
        if isinstance(t, dict):
            return {k: keep(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [keep(v) for v in t]
        return types.SimpleNamespace(shape=tuple(t.shape))

    out = {}
    for k, v in tree.items():
        if k in ("blocks", "periods") and isinstance(v, dict):
            n = jax.tree.leaves(v)[0].shape[0]
            out[k] = [drop(v)] * n
        else:
            out[k] = keep(v)
    return out


def _pairs(port, ref, path=()):
    """(path, port spec, reference spec) for every leaf; the reference's
    stacked entries match each list entry of the port's, their leading
    layer axis dropped."""
    if isinstance(port, dict):
        for k in port:
            yield from _pairs(port[k], ref[k], (*path, k))
    elif isinstance(port, list) and not isinstance(port, sh.P):
        for i, v in enumerate(port):
            if isinstance(ref, (list, tuple)) and not hasattr(ref, "spec"):
                yield from _pairs(v, ref[i], (*path, i))
            else:                                   # the reference stacks this level
                yield from _pairs(v, _shift(ref), (*path, i))
    else:
        yield path, port, ref


def _shift(ref):
    """A stacked subtree of the reference's shardings as per-layer specs."""
    if isinstance(ref, dict):
        return {k: _shift(v) for k, v in ref.items()}
    spec = ref.spec
    assert len(spec) == 0 or spec[0] is None, spec        # the layer axis is never sharded
    return types.SimpleNamespace(spec=tuple(spec)[1:])


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_specs_match_reference_every_leaf(name, shape):
    jcfg = jax_get_config(name)
    tree = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg))
    want = jsh.param_shardings(tree, _jmesh(shape), jcfg)
    got = sh.param_specs(_unstack(tree), sh.AbstractMesh(shape, ("data", "model")),
                         get_config(name))
    n = 0
    for path, g, w in _pairs(got, want):
        assert g == _p(w.spec), (name, path)
        n += 1
    assert n >= len(jax.tree.leaves(tree))
    # the shardings' tree carries the same specs
    shd = sh.param_shardings(_unstack(tree), sh.AbstractMesh(shape, ("data", "model")),
                             get_config(name))
    assert shd["embed"]["e"].spec == got["embed"]["e"]


def _mesh16():
    return sh.AbstractMesh((16, 16), ("data", "model")), _jmesh((16, 16))


@pytest.mark.parametrize("path,shape", [
    ("blocks.3.attn.q.w", (1024, 2048)), ("blocks.3.attn.q.w", (4096, 4096)),
    ("blocks.0.attn.o.w", (2048, 1024)), ("blocks.1.mlp.experts.up.w", (64, 2048, 1408)),
    ("blocks.1.mlp.experts.up.w", (8, 6144, 16384)),
    ("blocks.1.mlp.experts.down.w", (8, 16384, 6144)),
    ("blocks.2.attn.q.w", (100, 102)), ("embed.e", (151936, 1024)),
    ("lm_head.w", (4096, 151936)), ("blocks.0.rec.conv_w", (4, 4096)),
    ("blocks.0.rec.lam", (4096,)), ("blocks.0.attn_norm.scale", (1024,)),
    ("enc_pos.e", (1500, 512)), ("blocks.0.mlp.router.w", (2048, 64)),
])
def test_reference_rule_cases(path, shape):
    """The reference's own cases (col/row rules, FSDP over data from 4M
    elements, expert parallel vs TP inside the expert, the divisibility
    guard), the reference's path being the port's without the layer
    index."""
    mesh, jmesh = _mesh16()
    ref_path = ".".join(s for s in path.split(".") if not s.isdigit())
    assert sh.param_spec(path, shape, mesh) == _p(jsh.param_spec(ref_path, shape, jmesh))


def test_reference_cases_named():
    mesh, _ = _mesh16()
    assert sh.param_spec("blocks.0.attn.q.w", (1024, 2048), mesh) == sh.P(None, "model")
    assert sh.param_spec("blocks.0.attn.q.w", (4096, 4096), mesh) == sh.P("data", "model")
    assert sh.param_spec("blocks.0.attn.o.w", (2048, 1024), mesh) == sh.P("model", None)
    assert sh.param_spec("blocks.0.mlp.experts.up.w", (64, 2048, 1408), mesh)[0] == "model"
    spec = sh.param_spec("blocks.0.mlp.experts.up.w", (8, 6144, 16384), mesh)
    assert spec[0] is None and spec[2] == "model"
    assert sh.param_spec("blocks.0.attn.q.w", (100, 102), mesh) == sh.P(None, None)


@pytest.mark.parametrize("quantized_kv", (False, True))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_batch_and_cache_specs_match_reference(name, quantized_kv):
    cfg, jcfg = get_config(name), jax_get_config(name)
    for shape_, jshape in zip(LM_SHAPES, JAX_LM_SHAPES):
        for mshape in MESHES:
            mesh = sh.AbstractMesh(mshape, ("data", "model"))
            got = sh.batch_specs(cfg, shape_, mesh, quantized_kv=quantized_kv)
            want = jsh.batch_specs(jcfg, jshape, _jmesh(mshape), quantized_kv=quantized_kv)
            flat_w = jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
            flat_g = list(_flat(got))
            assert [k for k, _ in flat_g] == [jax.tree_util.keystr(k) for k, _ in flat_w]
            for (_, g), (_, w) in zip(flat_g, flat_w):
                assert g == _p(w), (name, shape_.name, mshape)


def _flat(tree, path=""):
    """(``keystr``-like path, spec) in ``jax.tree`` order (keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, list) and not isinstance(tree, sh.P):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_cache_specs_match_port_cache_structure(name):
    """Each spec's length is its cache leaf's rank, key for key, for the
    port's ``make_cache`` (reduced config, on the CPU)."""
    cfg = reduce_config(get_config(name)).replace(dtype="float32")
    mesh = sh.AbstractMesh((2, 4), ("data", "model"))
    for q in ((False, True) if cfg.kind in ("dense", "vlm") else (False,)):
        cache = lm.make_cache(cfg, 2, 64, quantized=q, device="cpu")
        specs = sh.cache_specs(cfg, LM_SHAPES[2], mesh, quantized_kv=q)

        def walk(c, s, path):
            if isinstance(c, dict):
                assert set(c) == set(s), (name, path)
                for k in c:
                    walk(c[k], s[k], f"{path}.{k}")
            elif isinstance(c, list):
                assert len(c) == len(s), (name, path)
                for i, (a, b) in enumerate(zip(c, s)):
                    walk(a, b, f"{path}.{i}")
            else:
                assert isinstance(s, sh.P) and len(s) == c.dim(), (name, path, s, c.shape)
        walk(cache, specs, name)


@pytest.mark.parametrize("step", ("train", "prefill", "decode"))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_act_rules_and_opt_state_match_reference(name, step):
    for mshape in MESHES:
        mesh = sh.AbstractMesh(mshape, ("data", "model"))
        got = sh.default_act_rules(mesh, step, get_config(name))
        want = jsh.default_act_rules(_jmesh(mshape), step, jax_get_config(name))
        assert got == {k: _p(v) for k, v in want.items()}
    psh = {"w": sh.NamedSharding(mesh, sh.P(None, "model"))}
    osh = sh.opt_state_shardings(psh, mesh)
    assert osh["m"] is psh and osh["v"] is psh and osh["step"].spec == sh.P()


def test_reduced_param_specs_on_the_port_tree():
    """The port's own reduced trees (``init_params`` on the CPU) against the
    reference's reduced trees: the same specs layer for layer."""
    for name in ARCH_NAMES:
        cfg = reduce_config(get_config(name)).replace(dtype="float32")
        jcfg = jax_reduce_config(jax_get_config(name)).replace(dtype="float32")
        params = lm.init_params(torch.Generator().manual_seed(0), cfg)
        tree = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg))
        for shape in MESHES:
            got = sh.param_specs(params, sh.AbstractMesh(shape, ("data", "model")), cfg)
            want = jsh.param_shardings(tree, _jmesh(shape), jcfg)
            for path, g, w in _pairs(got, want):
                assert g == _p(w.spec), (name, path)


def test_plan_for_devices_matches_reference():
    for n in (1, 2, 4, 6, 8, 16, 32):
        for mp in (1, 2, 4, 8):
            if n % mp:
                with pytest.raises(ValueError):
                    plan_for_devices(n, mp, 2)
                continue
            for old in (1, 2, 3, 4, 8):
                got, want = plan_for_devices(n, mp, old, 1, 2), jax_plan(n, mp, old, 1, 2)
                assert got.mesh_shape == want.mesh_shape and got.mesh_axes == want.mesh_axes
                assert got.microbatch_scale == want.microbatch_scale
                assert (got.shard.rank, got.shard.world) == \
                    (want.shard.rank, want.shard.world)


def test_placements_from_specs():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sh.placements(sh.P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert sh.placements(sh.P(None, None), mesh) == (Replicate(),) * 3
    assert sh.placements(sh.P(), mesh) == (Replicate(),) * 3
    assert sh.placements(sh.P("model", "data"), mesh) == (Replicate(), Shard(1), Shard(0))
    with pytest.raises(ValueError, match="order"):
        sh.placements(sh.P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="twice"):
        sh.placements(sh.P("model", "model"), mesh)
    mesh2 = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    assert sh.placements(sh.P(("data",), "model"), mesh2) == (Shard(0), Shard(1))
    assert np.all([isinstance(p, Replicate) for p in sh.placements(sh.P(None), mesh2)])
