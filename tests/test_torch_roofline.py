"""The port's roofline (``roofline/analysis.py``, ``roofline/dispatch.py``)
against the reference's (``src/repro/roofline/``) on the CPU.

* ``model_flops`` and ``useful_fraction`` are pure arithmetic on the
  config: equal to the reference's, for every arch x ``valid_cells``
  cell x the dry run's five variants, at 256 and 512 chips.
* The counter on known ops: an mm's FLOPs and bytes, no bytes for a
  view, each dtype's own size; ``type_bytes`` as the reference's test
  holds its HLO twin (``tests/test_roofline.py:92``).
* Collectives on 2 spawned gloo ranks: an all-reduce counts twice its
  bytes, an all-gather its output, through ``c10d`` and the functional
  collectives.
* Against the reference's HLO walker (``analyze_compiled``; its jnp
  engine) on reduced stablelm-3b at 2 x 64 tokens: the train step's dot
  FLOPs within 2 %, one prefill and one decode step and a sparse train
  step (the port's junctions on ``meta`` through their plain versions)
  too.  The dense train step counts 4,194,304 FLOPs fewer (1.1 %): in
  its backward the reference recomputes each query chunk's scores
  q . k^T (``dot`` bf16 [2, 4, 32, 32] x [2, 4, 32, 64], 1,048,576
  FLOPs, 2 chunks x 2 layers) inside the transposed scan over the
  attention chunks, where the port's autograd keeps the probabilities of
  its forward and recomputes nothing.  ``mem_bytes`` is printed beside
  the reference's, not held: eager ops and XLA's fusions move different
  bytes by design.
* Full-size cells on ``meta``: dense stablelm-3b ``train_4k`` counts
  exactly the FLOPs of its matmul shapes in closed form
  (``_dense_train_flops``), and the ``perf-sparse`` variant runs its
  junctions through the ``meta`` route; neither allocates a tensor off
  ``meta`` past a 0-d scalar.
* The routes: a ``meta`` or CPU tensor takes each wrapper's plain
  version, any device but the card's raises.
"""
import dataclasses
import inspect
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro.configs import registry as jreg
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.base import valid_cells as jvalid_cells
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.launch import specs as jspecs
from repro.models import model as JM
from repro.optim import adam as jadam
from repro.optim import constant_schedule as jconstant
from repro.roofline import analysis as janalysis
from repro.train import steps as jsteps

from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES, ShapeSpec, valid_cells
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.kernels import ops
from repro_torch.launch import specs as tspecs
from repro_torch.launch.dryrun import VARIANTS, _apply_variant
from repro_torch.models import model as TM
from repro_torch.optim import adam, constant_schedule
from repro_torch.roofline import analysis, dispatch
from repro_torch.train import steps as tsteps
from torch_mesh_workers import collective_counts, run_ranks
from torch_parity_helpers import reference_variant

WALKER_REL = 0.02
ATTN_RECOMPUTE = 4_194_304       # the reference's backward score products


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_model_flops_and_useful_fraction_equal_reference(arch):
    for variant in VARIANTS:
        tcfg = _apply_variant(treg.get(arch), variant)
        jcfg = reference_variant(jreg.get(arch), tcfg)
        assert tcfg.active_param_count() == jcfg.active_param_count()
        jcells, tcells = list(jvalid_cells(jcfg)), list(valid_cells(tcfg))
        assert [s.name for s in tcells] == [s.name for s in jcells]
        for js, ts in zip(jcells, tcells):
            want = janalysis.model_flops(jcfg, js)
            assert analysis.model_flops(tcfg, ts) == want
            for n_chips in (256, 512):
                for per_dev in (0.0, 3.1e13, want / n_chips):
                    assert analysis.useful_fraction(
                        tcfg, ts, per_dev, n_chips) == \
                        janalysis.useful_fraction(jcfg, js, per_dev,
                                                  n_chips)


# ---------------------------------------------------- counts of known ops
def test_mm_counts_its_flops_and_bytes():
    M, K, N = 48, 64, 80
    a = torch.randn(M, K, dtype=torch.bfloat16)
    b = torch.randn(K, N, dtype=torch.bfloat16)
    with dispatch.DispatchCounter() as c:
        torch.mm(a, b)
    assert c.dot_flops == 2 * M * N * K
    assert c.mem_bytes == (M * K + K * N + M * N) * 2
    assert c.coll_bytes == 0 and c.coll_detail == {}


def test_views_count_no_bytes_and_dtypes_their_own_size():
    x = torch.randn(8, 16, device="meta")
    with dispatch.DispatchCounter() as c:
        x.view(16, 8).reshape(2, 64).t()[:, 1].unsqueeze(0)
        x.transpose(0, 1).reshape(-1)               # not a view: copies
    assert c.dot_flops == 0 and c.mem_bytes == 2 * 8 * 16 * 4
    with dispatch.DispatchCounter() as c:
        x.to(torch.bfloat16)
    assert c.mem_bytes == 8 * 16 * (4 + 2)
    q = torch.zeros(8, 16, dtype=torch.int8, device="meta")
    with dispatch.DispatchCounter() as c:
        q + q
        torch.empty(1000, device="meta")           # allocates, moves nothing
    assert c.mem_bytes == 3 * 8 * 16
    with dispatch.DispatchCounter() as c:
        x.add_(1.0)                                # writes in place
    assert c.mem_bytes == 2 * 8 * 16 * 4


def test_type_bytes():
    meta = dict(device="meta")
    assert dispatch.type_bytes(torch.empty(64, 256, dtype=torch.bfloat16,
                                           **meta)) == 64 * 256 * 2
    assert dispatch.type_bytes(torch.empty((), **meta)) == 4
    assert dispatch.type_bytes((torch.empty((), dtype=torch.int32, **meta),
                                torch.empty(8, 8, dtype=torch.bfloat16,
                                            **meta))) == 4 + 128
    assert dispatch.type_bytes(torch.empty(16, dtype=torch.bool,
                                           **meta)) == 16
    assert [dispatch.type_bytes(d) for d in (
        torch.bfloat16, torch.int8, torch.float32, torch.bool)] == [2, 1, 4, 1]


def test_collectives_on_two_gloo_ranks(tmp_path):
    """Rank r all-reduces 1024 fp32 (2 x 4096 bytes) and all-gathers 2 x
    256 bf16 (1024 bytes out) through c10d, then the same two through the
    functional collectives."""
    run_ranks(collective_counts, 2, str(tmp_path))
    for rank in range(2):
        got = np.load(tmp_path / f"coll_{rank}.npz")
        assert got["reduced"].tolist() == (2 * np.arange(1024) + 1).tolist()
        for api in ("c10d", "functional"):
            assert got[f"{api}_all-reduce"].tolist() == [2 * 4096, 1]
            assert got[f"{api}_all-gather"].tolist() == [1024, 1]
            assert got[f"{api}_total"] == 2 * 4096 + 1024


# ----------------------------------------- against the reference's walker
def _cells(kind, sparse):
    jcfg = dataclasses.replace(jreg.get("stablelm-3b").reduced(),
                               engine="jnp")
    tcfg = treg.get("stablelm-3b").reduced()
    if sparse:
        jcfg = jcfg.with_sparsity(JSparsity(0.25, 32, "ffn"))
        tcfg = tcfg.with_sparsity(SparsityConfig(0.25, 32, "ffn"))
    return (jcfg, JShapeSpec("walker", 64, 2, kind),
            tcfg, ShapeSpec("walker", 64, 2, kind))


def _reference(jcfg, shape):
    """The reference's roofline of one cell, compiled for the CPU."""
    params = jax.eval_shape(lambda k: JM.init(jcfg, k),
                            jax.random.PRNGKey(0))
    if shape.kind == "train":
        opt = jadam(jconstant(1e-4))
        fn = jsteps.make_train_step(jcfg, opt, jit=False)
        args = (params, jax.eval_shape(opt.init, params),
                jspecs.batch_struct(jcfg, shape),
                jax.ShapeDtypeStruct((), jnp.int32))
    elif shape.kind == "prefill":
        fn = jsteps.make_prefill_step(jcfg)
        args = (params, jspecs.batch_struct(jcfg, shape))
    else:
        fn = jsteps.make_decode_step(jcfg)
        cache = jax.eval_shape(lambda: JM.make_cache(
            jcfg, shape.global_batch, shape.seq_len))
        args = (params, cache, *jspecs.decode_inputs_struct(jcfg, shape))
    return janalysis.analyze_compiled(jax.jit(fn).lower(*args).compile())


def _port(tcfg, shape):
    """The port's roofline of the same cell, on ``meta`` tensors."""
    params = TM.init(tcfg, 0, "meta")
    if shape.kind == "train":
        opt = adam(constant_schedule(1e-4))
        return analysis.analyze(tsteps.make_train_step(tcfg, opt), params,
                                opt.init(params),
                                tspecs.batch_struct(tcfg, shape), 0)
    if shape.kind == "prefill":
        return analysis.analyze(tsteps.make_prefill_step(tcfg), params,
                                tspecs.batch_struct(tcfg, shape))
    cache = TM.make_cache(tcfg, shape.global_batch, shape.seq_len, "meta")
    token, _ = tspecs.decode_inputs_struct(tcfg, shape)
    return analysis.analyze(tsteps.make_decode_step(tcfg), params, cache,
                            token, shape.seq_len - 1)


@pytest.mark.parametrize("kind,sparse,gap", [
    ("train", False, ATTN_RECOMPUTE), ("prefill", False, 0),
    ("decode", False, 0), ("train", True, 0)],
    ids=["train", "prefill", "decode", "sparse_train"])
def test_dot_flops_match_reference_walker(kind, sparse, gap):
    jcfg, jshape, tcfg, tshape = _cells(kind, sparse)
    want, got = _reference(jcfg, jshape), _port(tcfg, tshape)
    print(f"[roofline] {kind}{' sparse' if sparse else ''}: dot_flops "
          f"{got.dot_flops} (reference {want.dot_flops:.0f}), mem_bytes "
          f"{got.mem_bytes} (reference {want.mem_bytes:.0f})")
    assert abs(got.dot_flops - want.dot_flops) <= WALKER_REL * want.dot_flops
    assert want.dot_flops - got.dot_flops == gap
    assert got.coll_bytes == 0 and got.dominant in ("compute", "memory")
    assert got.t_compute == got.dot_flops / analysis.PEAK_FLOPS
    assert got.t_memory == got.mem_bytes / analysis.HBM_BW
    assert set(got.to_json()) == {
        "dot_flops", "mem_bytes", "coll_bytes", "t_compute", "t_memory",
        "t_collective", "dominant", "coll_detail", "memory_stats"}


# ------------------------------------------------ full-size cells on meta
class _OffMeta(dispatch.DispatchCounter):
    """Also records every op output that lies off ``meta`` (shape, op)."""

    def __init__(self):
        super().__init__()
        self.off_meta = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        self.off_meta += [(tuple(t.shape), str(func))
                          for t in tree_leaves(out) if torch.is_tensor(t)
                          and t.device.type != "meta" and t.numel() > 1]
        return out


def _full_train(cfg):
    params = TM.init(cfg, 0, "meta")
    opt = adam(constant_schedule(1e-4),
               master_copy=cfg.param_dtype != "float32")
    step = tsteps.make_train_step(cfg, opt)
    with _OffMeta() as c:
        step(params, opt.init(params),
             tspecs.batch_struct(cfg, SHAPES["train_4k"]), 0)
    return c


def _dense_train_flops(cfg, shape):
    """The matmul FLOPs of one dense two-pass train step, from the shapes.

    A product of [M, K] by [K, N] is 2 M K N.  Each layer's products run
    forward, again in the backward's recompute (``cfg.remat``), and twice
    backward (dX and dW): four times.  Two run three times: the FFN's
    ``wo``, whose output nothing in the backward reads, so the
    recompute (``torch.utils.checkpoint`` without reentry) stops before
    it; and the head, unless ``cfg.loss_chunk`` runs it by chunks under
    a checkpoint of its own, which recomputes it (and unembeds only the
    S - 1 positions of a row that have a label).  Attention multiplies every query by
    every key chunk (no causal skipping): scores and P.V forward, again
    in the recompute, and twice each backward."""
    T, d, f, V = shape.tokens, cfg.d_model, cfg.d_ff, cfg.vocab
    q, kv = cfg.n_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    proj = 2 * T * d * (2 * q + 2 * kv)               # wq, wk, wv, wo
    attn = 2 * 2 * shape.global_batch * cfg.n_heads * shape.seq_len ** 2 \
        * cfg.head_dim                                # q.k^T and p.v
    ffn_in = 2 * 2 * T * d * f                        # wg and wi
    ffn_out = 2 * T * f * d                           # wo
    layer = 4 * (proj + attn + ffn_in) + 3 * ffn_out
    head = 3 * 2 * T * d * V
    if cfg.loss_chunk:
        head = 4 * 2 * shape.global_batch * (shape.seq_len - 1) * d * V
    return cfg.n_layers * layer + head


@pytest.mark.parametrize("variant", ["dense", "perf"])
def test_full_size_dense_train_counts_on_meta(variant):
    cfg = _apply_variant(treg.get("stablelm-3b"), variant)
    assert cfg.remat and cfg.act == "silu" and cfg.sparsity is None
    c = _full_train(cfg)
    assert c.dot_flops == _dense_train_flops(cfg, SHAPES["train_4k"])
    assert c.off_meta == []


def test_full_size_sparse_train_runs_through_the_meta_route():
    cfg = _apply_variant(treg.get("stablelm-3b"), "perf-sparse")
    ops.reset_launch_counts()
    c = _full_train(cfg)
    assert set(ops.launch_counts().values()) == {0}
    assert c.off_meta == []
    # the FFN's junctions keep about an eighth of their blocks (2 of 20
    # and 7 of 54 input blocks a row here; the plain dx also runs its
    # padded reverse slots), so at least three quarters of the dense
    # FFN's products (3 a layer, run forward, again under remat and twice
    # backward) go
    ffn = 4 * 3 * 2 * cfg.d_model * cfg.d_ff * SHAPES["train_4k"].tokens \
        * cfg.n_layers
    dense = _dense_train_flops(dataclasses.replace(cfg, sparsity=None),
                               SHAPES["train_4k"])
    assert 0 < c.dot_flops <= dense - 3 / 4 * ffn


# ------------------------------------------------------------- the routes
_REFS = {"junction_fwd": "fwd_ref", "junction_dx": "dx_ref",
         "junction_dw": "dw_ref", "junction_update_dw": "update_dw_ref",
         "junction_gated_fwd": "gated_fwd_ref",
         "junction_gated_dx": "gated_dx_ref",
         "junction_gated_dw": "gated_dw_ref",
         "junction_update_gated_dw": "update_gated_dw_ref",
         "junction_fwd_int8": "fwd_int8_ref",
         "junction_gated_fwd_int8": "gated_fwd_int8_ref",
         "junction_fwd_fxp": "fwd_fxp_ref",
         "flash_decode": "paged_decode_ref",
         "flash_attention": "attention_ref",
         "selective_scan": "selective_scan_ref", "qmatmul": "qmatmul_ref",
         "lut_lookup": "lut_lookup_ref"}


@pytest.mark.parametrize("name", sorted(_REFS))
def test_meta_and_cpu_take_the_plain_version(name, monkeypatch):
    fn = ops._COUNTED[name]
    monkeypatch.setattr(sys.modules[fn.__module__], _REFS[name],
                        lambda first, *a, **k: ("plain", first.device.type))
    sig = inspect.signature(fn)
    n_pos = sum(p.kind == p.POSITIONAL_OR_KEYWORD and p.default is p.empty
                for p in sig.parameters.values())
    kw = {p.name: None for p in sig.parameters.values()
          if p.kind == p.KEYWORD_ONLY and p.default is p.empty}
    before = fn.launches
    for dev in ("meta", "cpu"):
        first = torch.zeros(1, device=dev)
        assert fn(first, *[None] * (n_pos - 1), **kw) == ("plain", dev)
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="runs on cpu, meta or cuda"):
        fn(other, *[None] * (n_pos - 1), **kw)
    assert fn.launches == before
