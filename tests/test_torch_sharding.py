"""The port's sharding rules (``parallel/sharding.py``), hints, shape
specs and meta-device init against the JAX reference, with no device
allocated.

For every arch of the registry, both production meshes as abstract
meshes (16 x 16 and 2 x 16 x 16), dense and with
``with_sparsity(density 0.25, block 128, where="ffn")``:

* ``param_specs`` equals the reference's leaf for leaf (the reference on
  ``jax.eval_shape``, the port on ``meta`` tensors), a layer's spec being
  the reference's with its stack dims (one; the hybrid's two) taken off;
* ``cache_specs`` (at batch 128, 32768 positions), ``batch_specs`` (every
  valid cell of SHAPES, and batch 1 of falcon-mamba's 524288 tokens) and
  ``logits_spec`` equal the reference's;
* the reference's own invariants (tests/test_sharding.py): every sharded
  dim divides its axes, whisper's "sp" strategy puts no weight on
  "model", the cache shards on "model", batch 1 replicates, the
  attention head guard;
* ``specs.batch_struct`` / ``decode_inputs_struct``, SHAPES and
  ``valid_cells`` equal the reference's; ``concrete_batch``'s shapes,
  dtypes and ranges (the RNGs differ, so not its values);
* ``to_shardings``' placements; ``hints``: outside a mesh and on plain
  tensors inside one every anchor returns its input, and the forward
  reaches the reference's anchors (embedding, each stacked layer, each
  hybrid super-block) without changing a value.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.launch import specs as jspecs
from repro.models import model as JM
from repro.parallel import sharding as jsh

from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import model as TM
from repro_torch.parallel import hints
from repro_torch.parallel import sharding as sh
from repro_torch.tree import tree_items, tree_leaves

ARCHS = list(treg.ARCHS)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
SPARSE = dict(density=0.25, block=128, where="ffn")


def _jmesh(name):
    sizes, names = MESHES[name]
    try:  # jax >= 0.5: AbstractMesh(axis_sizes, axis_names)
        return JAbstractMesh(sizes, names)
    except TypeError:  # jax 0.4.x: AbstractMesh(((name, size), ...))
        return JAbstractMesh(tuple(zip(names, sizes)))


def _tmesh(name):
    return AbstractMesh(*MESHES[name])


def _cfgs(arch, sparse):
    jcfg, tcfg = jreg.get(arch), treg.get(arch)
    if sparse:
        jcfg = jcfg.with_sparsity(JSparsity(**SPARSE))
        tcfg = tcfg.with_sparsity(SparsityConfig(**SPARSE))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _pshapes(arch, sparse):
    """Both sides' params at full size, allocating nothing."""
    jcfg, tcfg = _cfgs(arch, sparse)
    jp = jax.eval_shape(functools.partial(JM.init, jcfg),
                        jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, TM.init(tcfg, 0, "meta")


def _is_jspec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _same_specs(port, ref, nstack=0, path=""):
    """The port's spec tree against the reference's: a list level of the
    port's layers is one stack dim of the reference's leaves.  Returns
    the number of port leaves compared."""
    if isinstance(port, dict):
        assert set(port) == set(ref), path
        return sum(_same_specs(port[k], ref[k], nstack, f"{path}/{k}")
                   for k in port)
    if isinstance(port, list):
        return sum(_same_specs(v, ref, nstack + 1, f"{path}/{i}")
                   for i, v in enumerate(port))
    assert isinstance(port, sh.P) and _is_jspec(ref), path
    want = tuple(ref)
    assert want[:nstack] == (None,) * nstack, (path, want)
    assert tuple(port) == want[nstack:], (path, port, want)
    return 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh, sparse):
    jcfg, tcfg, jp, tp = _pshapes(arch, sparse)
    assert all(t.device.type == "meta" for t in tree_leaves(tp))
    want = jsh.param_specs(jcfg, jp, _jmesh(mesh))
    n = _same_specs(sh.param_specs(tcfg, tp, _tmesh(mesh)), want)
    assert n == len(tree_leaves(tp))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh):
    jcfg, tcfg = _cfgs(arch, False)
    jc = jax.eval_shape(lambda: JM.make_cache(jcfg, 128, 32768))
    tc = TM.make_cache(tcfg, 128, 32768, device="meta")
    _same_specs(sh.cache_specs(tcfg, tc, _tmesh(mesh)),
                jsh.cache_specs(jcfg, jc, _jmesh(mesh)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_logits_specs_match_reference(arch, mesh):
    jcfg, tcfg = _cfgs(arch, False)
    for shape in tbase.valid_cells(tcfg):
        jshape = jbase.SHAPES[shape.name]
        got = sh.batch_specs(tcfg, tspecs.batch_struct(tcfg, shape),
                             _tmesh(mesh))
        want = jsh.batch_specs(jcfg, jspecs.batch_struct(jcfg, jshape),
                               _jmesh(mesh))
        _same_specs(got, want)
        tok, pos = tspecs.decode_inputs_struct(tcfg, shape)
        jtok, jpos = jspecs.decode_inputs_struct(jcfg, jshape)
        _same_specs(sh.batch_specs(tcfg, {"t": tok, "p": pos}, _tmesh(mesh)),
                    jsh.batch_specs(jcfg, {"t": jtok, "p": jpos},
                                    _jmesh(mesh)))
    for batch in (1, 8, 128, 256):
        _same_specs(sh.logits_spec(tcfg, batch, _tmesh(mesh)),
                    jsh.logits_spec(jcfg, batch, _jmesh(mesh)))


def test_batch_specs_long_context_b1_matches_reference():
    jcfg, tcfg = _cfgs("falcon-mamba-7b", False)
    tb = {"tokens": torch.empty((1, 524288), dtype=torch.int32,
                                device="meta")}
    jb = {"tokens": jax.ShapeDtypeStruct((1, 524288), jnp.int32)}
    for mesh in MESHES:
        got = sh.batch_specs(tcfg, tb, _tmesh(mesh))
        _same_specs(got, jsh.batch_specs(jcfg, jb, _jmesh(mesh)))
        assert got["tokens"][0] is None     # batch 1 cannot shard


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_divisible(arch, mesh):
    """Every sharded dim divides its mesh axes; spec rank == leaf rank."""
    _, tcfg, _, tp = _pshapes(arch, True)
    m = _tmesh(mesh)
    sizes = sh.axis_sizes(m)
    specs = dict(sh.spec_items(sh.param_specs(tcfg, tp, m)))
    for key, leaf in tree_items(tp):
        spec = specs[key]
        assert len(spec) == leaf.dim(), (key, spec, leaf.shape)
        for dim, ax in zip(leaf.shape, spec):
            if ax is None:
                continue
            n = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n *= sizes[a]
            assert dim % n == 0, (key, spec, leaf.shape)


def test_sp_strategy_never_model_shards_weights():
    _, tcfg, _, tp = _pshapes("whisper-base", False)
    assert tcfg.strategy == "sp"
    for k, spec in sh.spec_items(sh.param_specs(tcfg, tp,
                                             _tmesh("single"))):
        assert "model" not in [a for a in spec if isinstance(a, str)], (k,
                                                                       spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_shard_sequence(arch):
    tcfg = treg.get(arch)
    tc = TM.make_cache(tcfg, 128, 32768, device="meta")
    specs = sh.cache_specs(tcfg, tc, _tmesh("single"))
    assert any("model" in spec for _, spec in sh.spec_items(specs)), arch


def test_attention_head_guard():
    """whisper q/k/v/o replicate (8 heads < 16); qwen2 q shards, kv
    replicate (the reference's, stack dim taken off)."""
    m = _tmesh("single")
    _, cw, _, pw = _pshapes("whisper-base", False)
    _, cq, _, pq = _pshapes("qwen2-72b", False)
    sw, sq = sh.param_specs(cw, pw, m), sh.param_specs(cq, pq, m)
    assert sw["layers"][0]["attn"]["wq"]["w"] == sh.P("data", None)
    assert sq["layers"][0]["attn"]["wq"]["w"] == sh.P("data", "model")
    assert sq["layers"][0]["attn"]["wk"]["w"] == sh.P("data", None)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_struct_and_cells_match_reference(arch):
    jcfg, tcfg = _cfgs(arch, False)
    assert ([s.name for s in tbase.valid_cells(tcfg)]
            == [s.name for s in jbase.valid_cells(jcfg)])
    assert tbase.long_context_ok(tcfg) == jbase.long_context_ok(jcfg)
    assert tcfg.strategy == jcfg.strategy
    for name, shape in tbase.SHAPES.items():
        js = jbase.SHAPES[name]
        assert (shape.seq_len, shape.global_batch, shape.kind,
                shape.tokens) == (js.seq_len, js.global_batch, js.kind,
                                  js.tokens)
        got, want = (tspecs.batch_struct(tcfg, shape),
                     jspecs.batch_struct(jcfg, js))
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[k].shape
            assert str(t.dtype).split(".")[-1] == str(want[k].dtype)
        for t, w in zip(tspecs.decode_inputs_struct(tcfg, shape),
                        jspecs.decode_inputs_struct(jcfg, js)):
            assert tuple(t.shape) == w.shape
            assert str(t.dtype).split(".")[-1] == str(w.dtype)


@pytest.mark.parametrize("arch", ["stablelm-3b", "llava-next-mistral-7b",
                                  "whisper-base"])
def test_concrete_batch_structure_matches_reference(arch):
    jcfg, tcfg = jreg.get(arch).reduced(), treg.get(arch).reduced()
    gen = torch.Generator().manual_seed(3)
    got = tspecs.concrete_batch(tcfg, 4, 64, gen)
    want = jspecs.concrete_batch(jcfg, 4, 64, jax.random.PRNGKey(3))
    assert list(got) == list(want)
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape
        assert str(t.dtype).split(".")[-1] == str(want[k].dtype)
    V = tcfg.raw_vocab or tcfg.vocab
    assert int(got["tokens"].min()) >= 0 and int(got["tokens"].max()) < V
    for k in ("patches", "frames"):
        if k in got:        # standard normal draws
            assert abs(float(got[k].mean())) < 0.1
            assert abs(float(got[k].std()) - 1.0) < 0.1


def test_to_shardings_placements():
    m = _tmesh("multi")
    specs = {"w": sh.P(("pod", "data"), "model"), "b": sh.P(None),
             "s": sh.P()}
    got = sh.to_shardings(specs, m)
    assert got["w"] == (Shard(0), Shard(0), Shard(1))
    assert got["b"] == (Replicate(),) * 3
    assert got["s"] == (Replicate(),) * 3
    # a 0-d placeholder under a rank-2 spec is replicated
    assert sh._placements(sh.P("data", "model"), 0, m) == (Replicate(),) * 3


@pytest.mark.parametrize("arch", ["stablelm-3b", "deepseek-v2-lite-16b",
                                  "zamba2-2.7b", "whisper-base",
                                  "falcon-mamba-7b"])
def test_meta_init_matches_cpu_init(arch):
    """The meta-device init has the CPU init's tree, shapes and dtypes."""
    cfg = treg.get(arch).reduced().with_sparsity(
        SparsityConfig(density=0.5, block=32, where="ffn"))
    meta, cpu = TM.init(cfg, 0, "meta"), TM.init(cfg, 0, "cpu")
    got, want = dict(tree_items(meta)), dict(tree_items(cpu))
    assert got.keys() == want.keys()
    for k, t in got.items():
        assert t.device.type == "meta"
        assert (t.shape, t.dtype) == (want[k].shape, want[k].dtype), k


def _anchors(cfg) -> int:
    """The reference's constrain_tokens3d calls in one forward: the
    embedding, each layer of the scanned stack, each hybrid super-block."""
    if cfg.family == "hybrid":
        n_super = cfg.n_layers // cfg.hybrid_attn_every
        return 1 + cfg.n_layers + n_super
    nd = cfg.moe.first_dense_layers if cfg.family == "moe" else 0
    return 1 + cfg.n_layers - nd


@pytest.mark.parametrize("arch", ["stablelm-3b", "deepseek-v2-lite-16b",
                                  "zamba2-2.7b", "whisper-base",
                                  "falcon-mamba-7b", "llava-next-mistral-7b"])
def test_hint_anchors_reached_and_change_nothing(arch, monkeypatch):
    import dataclasses
    cfg = dataclasses.replace(treg.get(arch).reduced(), dtype="float32")
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, n_layers=3)
    params = TM.init(cfg, 0, "cpu")
    gen = torch.Generator().manual_seed(0)
    batch = tspecs.concrete_batch(cfg, 2, 16, gen)
    seen = []
    real = hints.constrain_tokens3d

    def counting(x, c):
        out = real(x, c)
        seen.append(out is x)
        return out

    monkeypatch.setattr(hints, "constrain_tokens3d", counting)
    with torch.no_grad():
        plain, _, _ = TM.forward(cfg, params, batch)
        assert len(seen) == _anchors(cfg) and all(seen)
        with hints.use_mesh_hints(_tmesh("single")):
            assert hints.current_mesh() is not None
            hinted, _, _ = TM.forward(cfg, params, batch)
    assert hints.current_mesh() is None
    assert len(seen) == 2 * _anchors(cfg) and all(seen)
    assert torch.equal(plain, hinted)
