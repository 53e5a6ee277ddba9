"""Rank bodies for tests/test_torch_mesh.py, tests/test_torch_roofline.py
and tests/test_torch_dryrun.py, run as spawned gloo processes
(one a rank, one torch thread each).  Plain module, no JAX: each rank
imports torch and the port only.  Inputs and results cross through .npz
files in the test's directory."""
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_ranks(fn, world: int, *args) -> None:
    """fn(rank, *args) on ``world`` gloo ranks; raises if a rank raises
    (the others are stopped)."""
    join_ranks(start_ranks(fn, world, *args))


def start_ranks(fn, world: int, *args):
    """``run_ranks`` without waiting: the ranks' context, for
    ``join_ranks`` once the caller has done its own work meanwhile."""
    store = f"{args[0]}/store_{fn.__name__}"
    return mp.start_processes(_enter, args=(fn, world, store, args),
                              nprocs=world, join=False,
                              start_method="spawn")


def join_ranks(ctx) -> None:
    """Wait for ``start_ranks``' ranks; raises if a rank raised."""
    while not ctx.join():
        pass


def _enter(rank, fn, world, store, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(minutes=5))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def _save_tree(path, tree, **extra):
    from repro_torch.tree import tree_items
    np.savez(path, **{f"leaf:{k}": v.float().numpy()
                      if v.is_floating_point() else v.numpy()
                      for k, v in tree_items(tree)},
             **{k: np.asarray(v) for k, v in extra.items()})


def shard_counts(tree, spec_tree, mesh) -> bool:
    """Whether each DTensor leaf holds its full numel over the product of
    the mesh axes its spec shards (0-d placeholders: replicated)."""
    from repro_torch.parallel import sharding as sh
    from repro_torch.tree import tree_items
    sizes = sh.axis_sizes(mesh)
    specs = dict(sh.spec_items(spec_tree))
    for key, t in tree_items(tree):
        spec = specs[key]
        n = 1
        if len(spec) <= t.dim():
            for ax in spec:
                for a in (ax if isinstance(ax, tuple) else
                          () if ax is None else (ax,)):
                    n *= sizes[a]
        if t.to_local().numel() * n != t.numel():
            return False
    return True


def sharded_step(rank, d, dtypes, data, model):
    """One Adam step of reduced deepseek-7b (the reference's carried
    weights, ``in.npz``) on a (data, model) mesh in each of ``dtypes``;
    rank 0 writes the gathered params, Adam's m and the loss to
    ``out_<dtype>.npz`` and the at-rest check to ``ok``.  Also a hinted
    DTensor anchor."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.convert import from_jax_params
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import adam, constant_schedule
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.steps import make_mesh_train_step
    from repro_torch.tree import tree_leaves
    from torch.distributed.tensor import Replicate, distribute_tensor

    raw = dict(np.load(f"{d}/in.npz"))
    batch = {"tokens": raw.pop("batch_tokens")}
    tree = {}
    for k, v in raw.items():              # "embed.tok" -> nested dicts
        node = tree
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    full = from_jax_params(tree)
    mesh = make_local_mesh(data, model, "cpu")
    ok = True
    for dtype in dtypes:
        cfg = dataclasses.replace(registry.get("deepseek-7b").reduced(),
                                  dtype=dtype)
        opt = adam(constant_schedule(1e-3), grad_clip=None)
        specs = sh.param_specs(cfg, full, mesh)
        params = sh.place(full, specs, mesh)
        state = sh.place_state(opt.init(full), specs, mesh)
        ok = ok and shard_counts(params, specs, mesh) and all(
            shard_counts(state[k], specs, mesh) for k in ("m", "v"))
        ok = ok and all(torch.equal(a, b) for a, b in zip(
            tree_leaves(sh.gather(params)), tree_leaves(full)))
        step = make_mesh_train_step(cfg, opt, mesh)
        p, s, m = step(params, state, batch, 0)
        ok = ok and shard_counts(p, specs, mesh)
        p, mom = sh.gather(p), sh.gather(s["m"])
        if rank == 0:
            _save_tree(f"{d}/out_{dtype}.npz", {"params": p, "m": mom},
                       loss=float(m["loss"]))
    x = distribute_tensor(torch.arange(4 * 8 * 16.0).reshape(4, 8, 16), mesh,
                          [Replicate(), Replicate()])
    with hints.use_mesh_hints(mesh):
        y = hints.constrain_tokens3d(x, None)
    ok = ok and tuple(y.to_local().shape) == (4 // data, 8 // model, 16)
    ok = ok and torch.equal(y.full_tensor(), x.full_tensor())
    oks = [None] * dist.get_world_size()
    dist.all_gather_object(oks, ok)
    if rank == 0:
        np.save(f"{d}/ok.npy", np.asarray(oks))


def fused_steps(rank, d, data, model, n_steps):
    """``n_steps`` fused Adam (clipped) steps of reduced sparse stablelm-3b
    in fp32 on a (data, model) mesh, through the gathered route
    (``make_gathered_mesh_train_step``, which the moe and audio families'
    fused steps take); rank 0 writes the gathered params and the losses
    to ``fused.npz``."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.steps import make_gathered_mesh_train_step

    cfg, opt, params, batches = fused_case(n_steps)
    mesh = make_local_mesh(data, model, "cpu")
    specs = sh.param_specs(cfg, params, mesh)
    placed = sh.place(params, specs, mesh)
    state = sh.place_state(opt.init(params), specs, mesh)
    del params
    step = make_gathered_mesh_train_step(cfg, opt, mesh)
    losses = []
    for i, batch in enumerate(batches):
        placed, state, m = step(placed, state, batch, i)
        losses.append(float(m["loss"]))
    full = sh.gather(placed)
    if rank == 0:
        _save_tree(f"{d}/fused.npz", full, losses=np.asarray(losses))


def fused_case(n_steps):
    """(cfg, optimizer, params, batches) of the fused comparison."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data.pipeline import LMTokenPipeline
    from repro_torch.models import model as M
    from repro_torch.optim import constant_schedule, fused_adam

    cfg = dataclasses.replace(
        registry.get("stablelm-3b").reduced().with_sparsity(
            SparsityConfig(density=0.5, block=32, where="ffn")),
        dtype="float32", param_dtype="float32", fused_update=True)
    opt = fused_adam(constant_schedule(1e-3), grad_clip=1.0)
    pipe = LMTokenPipeline(cfg, 4, 32)
    return (cfg, opt, M.init(cfg, 0, "cpu"),
            [next(pipe) for _ in range(n_steps)])


def collective_counts(rank, d):
    """tests/test_torch_roofline.py: an all-reduce of 1024 fp32 and an
    all-gather of 256 bf16 a rank under ``DispatchCounter``, once through
    c10d and once through the functional collectives."""
    import torch.distributed._functional_collectives as funcol
    from repro_torch.roofline import dispatch
    x = torch.arange(1024, dtype=torch.float32) + rank
    y = torch.full((256,), rank, dtype=torch.bfloat16)
    got = {}
    with dispatch.DispatchCounter() as c:
        dist.all_reduce(x)
        dist.all_gather([torch.empty_like(y) for _ in range(2)], y)
    got["reduced"] = x.numpy()
    with dispatch.DispatchCounter() as f:
        group = dist.group.WORLD
        funcol.all_reduce(x, "sum", group).wait()
        funcol.all_gather_tensor(y, 0, group).wait()
    for api, counter in (("c10d", c), ("functional", f)):
        for kind, (nbytes, n) in counter.coll_detail.items():
            got[f"{api}_{kind}"] = np.array([nbytes, n])
        got[f"{api}_total"] = counter.coll_bytes
    np.savez(f"{d}/coll_{rank}.npz", **got)


# the accounting cases of tests/test_torch_dryrun.py: (arch, sparse, compute
# dtype), each at a train batch, a prefill / decode batch that the data
# axis splits and one it does not
DRYRUN_CASES = [("deepseek-7b", False, "float32"),
                ("deepseek-7b", False, "bfloat16"),
                ("stablelm-3b", True, "float32"),
                ("stablelm-3b", True, "bfloat16")]
DRYRUN_SEQ, DRYRUN_ROWS = 32, (4, 3)


def dryrun_case(arch, sparse, dtype):
    """The reduced config of one accounting case (fp32 params; sparse:
    FFN junctions at density 0.5, block 32)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.core.sparsity import SparsityConfig
    cfg = registry.get(arch).reduced()
    if sparse:
        cfg = cfg.with_sparsity(SparsityConfig(density=0.5, block=32,
                                               where="ffn"))
    return dataclasses.replace(cfg, dtype=dtype)


def dryrun_inputs(cfg, B):
    """(params, batch of B x DRYRUN_SEQ, a random cache of that size, the
    decode token), the same on every rank: params from seed 0, the rest
    from a seeded CPU generator."""
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    gen = torch.Generator().manual_seed(B)
    batch = concrete_batch(cfg, B, DRYRUN_SEQ, gen)
    cache = tree_map(lambda t: torch.randn(t.shape, generator=gen).to(
        t.dtype), M.make_cache(cfg, B, DRYRUN_SEQ, "cpu"))
    token = torch.randint(0, cfg.vocab, (B, 1), dtype=torch.int32,
                          generator=gen)
    return M.init(cfg, 0, "cpu"), batch, cache, token


def dryrun_counts(rank, d):
    """Each accounting case on a 2 x 4 mesh: the mesh train step (B 4),
    and the mesh prefill and decode steps (B 4 and 3), each under
    ``DispatchCounter``; every rank writes its dot FLOPs, collectives and
    the bytes it holds of each placed tree to ``counts_<rank>.json``;
    rank 0 writes the gathered logits and caches to ``out_<case>.npz``."""
    import json

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import adam, constant_schedule
    from repro_torch.parallel import sharding as sh
    from repro_torch.roofline import dispatch
    from repro_torch.train import steps

    mesh = make_local_mesh(2, 4, "cpu")
    got = []

    def counted(fn, *args):
        with dispatch.DispatchCounter() as c:
            out = fn(*args)
        return out, {"dot_flops": c.dot_flops,
                     "coll": {k: list(v) for k, v in c.coll_detail.items()}}

    for i, case in enumerate(DRYRUN_CASES):
        cfg = dryrun_case(*case)
        saved = {}
        for B in DRYRUN_ROWS:
            params, batch, cache, token = dryrun_inputs(cfg, B)
            specs = sh.param_specs(cfg, params, mesh)
            placed = sh.place(params, specs, mesh)
            if B == DRYRUN_ROWS[0]:
                opt = adam(constant_schedule(1e-4), master_copy=False)
                state = sh.place_state(opt.init(params), specs, mesh)
                held = {"params": sh.held_bytes(placed)[0],
                        "opt_state": sh.held_bytes(state)[0]}
                step = steps.make_mesh_train_step(cfg, opt, mesh)
                (p, s, _), n = counted(step, placed, state, batch, 0)
                got.append(dict(n, case=i, kind="train", B=B, held=held,
                                after={"params": sh.held_bytes(p)[0],
                                       "opt_state": sh.held_bytes(s)[0]}))
            prefill = steps.make_mesh_prefill_step(cfg, mesh)
            (lg, c, npos), n = counted(prefill, placed, batch)
            got.append(dict(n, case=i, kind="prefill", B=B, npos=npos,
                            held={"params": sh.held_bytes(placed)[0],
                                  "cache": sh.held_bytes(c)[0],
                                  "logits": sh.held_bytes(lg)[0]}))
            saved[f"prefill_logits_{B}"] = lg.full_tensor()
            for k, v in sh.gather(c).items():
                saved[f"prefill_cache_{B}_{k}"] = v
            ccache = sh.place(cache, sh.cache_specs(cfg, cache, mesh), mesh)
            decode = steps.make_mesh_decode_step(cfg, mesh)
            held_c = sh.held_bytes(ccache)[0]
            (lg, c), n = counted(decode, placed, ccache, token,
                                 DRYRUN_SEQ - 1)
            got.append(dict(n, case=i, kind="decode", B=B,
                            held={"params": sh.held_bytes(placed)[0],
                                  "cache": held_c,
                                  "logits": sh.held_bytes(lg)[0]},
                            after={"cache": sh.held_bytes(c)[0]}))
            saved[f"decode_logits_{B}"] = lg.full_tensor()
            for k, v in sh.gather(c).items():
                saved[f"decode_cache_{B}_{k}"] = v
        if rank == 0:
            np.savez(f"{d}/out_{i}.npz", **{k: v.float().numpy()
                                            for k, v in saved.items()})
    with open(f"{d}/counts_{rank}.json", "w") as f:
        json.dump(got, f)


# tests/test_torch_partitioned.py: (arch, compute dtype, config changes)
# on a 2 x 4 mesh; sparse stablelm-3b at density 0.5, block 32 (FFN
# junctions of 4 and 8 output blocks, both split over "model"); the last
# case's 2 kv heads and 6-block FFN junctions do not divide the model
# axis, so wk / wv and wi / wg are replicated and computed whole; the
# chunked cross entropy's case runs PART_S + 1 positions (``part_seq``),
# which the model axis does not divide: the residual stays replicated
# (partial sums all-reduced), the cache whole, and its PART_S labels go
# through the vocab-parallel loss in chunks of 8
PART_CASES = [("deepseek-7b", "float32", {}),
              ("deepseek-7b", "bfloat16", {"loss_chunk": 8}),
              ("stablelm-3b", "float32", {}),
              ("stablelm-3b", "bfloat16", {}),
              ("stablelm-3b", "float32", {"kv_heads": 2, "d_ff": 192})]
PART_B, PART_S, PART_PROMPT, PART_DECODE = 4, 32, 27, 4


def part_seq(case) -> int:
    """The positions of a case's batch."""
    return PART_S + 1 if case[2].get("loss_chunk") else PART_S


def part_case(arch, dtype, changes):
    """The reduced config of one partitioned case (fp32 params)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.core.sparsity import SparsityConfig
    cfg = registry.get(arch).reduced()
    if arch == "stablelm-3b":
        cfg = cfg.with_sparsity(SparsityConfig(density=0.5, block=32,
                                               where="ffn"))
    return dataclasses.replace(cfg, dtype=dtype, **changes)


def _tree_from_flat(raw):
    tree = {}
    for k, v in raw.items():              # "embed.tok" -> nested dicts
        node = tree
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


class GatherLog:
    """What a rank holds gathered: each leaf gather's output bytes, and
    the most bytes of gathered leaves alive at once (a finalizer on each
    output's storage); and every ``DTensor.full_tensor`` /
    ``redistribute`` call while ``armed``."""

    def __init__(self):
        import weakref

        from torch.distributed.tensor import DTensor

        from repro_torch.parallel import partition
        self.sizes, self.live, self.peak, self.dtensor = [], 0, 0, []
        self.armed = False
        log = self

        def note(part, t):
            n = t.untyped_storage().nbytes()
            log.sizes.append(n)
            log.live += n
            log.peak = max(log.peak, log.live)
            weakref.finalize(t.untyped_storage(), log._free, n)

        partition.Partition.note_gather = note
        for name in ("full_tensor", "redistribute"):
            orig = getattr(DTensor, name)

            def spy(self, *a, _orig=orig, _name=name, **k):
                if log.armed:
                    log.dtensor.append((_name, tuple(self.shape)))
                return _orig(self, *a, **k)
            setattr(DTensor, name, spy)

    def _free(self, n):
        self.live -= n


def unit_budget(local, specs, mesh) -> int:
    """The largest unit's leaves gathered over the dp axes (a layer, a
    hybrid's Mamba layer or its shared block, an encoder layer, the
    encoder's norm, the embedding's tok, its out, the final norm):
    bytes."""
    from repro_torch.parallel import sharding as sh
    from repro_torch.tree import tree_items
    sizes = sh.axis_sizes(mesh)
    spec = dict(sh.spec_items(specs))

    def size(tree, prefix):
        total = 0
        for k, t in tree_items(tree, prefix):
            if torch.is_tensor(t) and t.is_floating_point():
                n = 1
                for e in spec[k]:
                    for a in sh.spec_axes(e):
                        n *= sizes[a] if a != "model" else 1
                total += t.numel() * t.element_size() * n
        return total
    units = []
    for k in ("dense_layers", "layers"):
        for i, lp in enumerate(local.get(k, ())):
            if isinstance(lp, list):        # the hybrid's super-block
                units += [size(v, f"{k}/{i}/{j}/") for j, v in enumerate(lp)]
            else:
                units.append(size(lp, f"{k}/{i}/"))
    if "shared_attn" in local:
        units.append(size(local["shared_attn"], "shared_attn/"))
    if "encoder" in local:                  # whisper's encoder
        units += [size(lp, f"encoder/layers/{i}/")
                  for i, lp in enumerate(local["encoder"]["layers"])]
        units.append(size(local["encoder"]["norm"], "encoder/norm/"))
    units += [size(local["embed"]["tok"], "embed/tok")]
    if "out" in local["embed"]:
        units.append(size(local["embed"]["out"], "embed/out"))
    units.append(size(local["final_norm"], "final_norm/"))
    return max(units)


def partitioned_run(rank, d):
    """Each PART_CASES case on a 2 x 4 mesh from the reference's carried
    weights (``in_<case>.npz``): one two-pass Adam step (clip 1.0) of
    PART_B x ``part_seq``, counted under ``DispatchCounter``; a prefill of
    the first PART_PROMPT tokens of each row, padded to ``part_seq``
    (the cache's size), and PART_DECODE
    greedy decode steps from position PART_PROMPT.  Rank 0 writes the
    gathered params, the loss, the logits and the tokens to
    ``out_<case>.npz``; every rank writes its gather log, its counts and
    the bytes it holds to ``log_<case>_<rank>.json``."""
    import json

    from repro_torch.convert import from_jax_params
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import adam, constant_schedule
    from repro_torch.parallel import partition
    from repro_torch.parallel import sharding as sh
    from repro_torch.roofline import dispatch
    from repro_torch.train import steps

    mesh = make_local_mesh(2, 4, "cpu")
    log = GatherLog()
    for i, case in enumerate(PART_CASES):
        cfg = part_case(*case)
        raw = dict(np.load(f"{d}/in_{i}.npz"))
        tokens = raw.pop("batch_tokens")
        full = from_jax_params(_tree_from_flat(raw))
        specs = sh.param_specs(cfg, full, mesh)
        placed = sh.place(full, specs, mesh)
        opt = adam(constant_schedule(1e-3), grad_clip=1.0)
        state = sh.place_state(opt.init(full), specs, mesh)
        budget = unit_budget(partition.local_tree(placed), specs, mesh)
        step = steps.make_mesh_train_step(cfg, opt, mesh)
        log.sizes, log.peak, log.dtensor = [], log.live, []
        start = log.live
        log.armed = True
        with dispatch.DispatchCounter() as c:
            p, s, m = step(placed, state, {"tokens": tokens}, 0)
        log.armed = False
        train = {"dot_flops": c.dot_flops, "gathers": len(log.sizes),
                 "largest": max(log.sizes), "peak": log.peak - start,
                 "budget": budget, "dtensor": log.dtensor,
                 "coll": {k: list(v) for k, v in c.coll_detail.items()},
                 "held": {"params": sh.held_bytes(placed)[0],
                          "opt_state": sh.held_bytes(state)[0]},
                 "after": {"params": sh.held_bytes(p)[0],
                           "opt_state": sh.held_bytes(s)[0]}}
        gp, gm = sh.gather(p), sh.gather(s["m"])
        # serving: the padded prompt, then greedy decode
        prompt = tokens.copy()
        prompt[:, PART_PROMPT:] = 0
        log.sizes, log.peak, log.dtensor = [], log.live, []
        start = log.live
        log.armed = True
        lg, cache, npos = steps.make_mesh_prefill_step(cfg, mesh)(
            placed, {"tokens": prompt})
        log.armed = False
        logits = [lg.full_tensor()]
        decode = steps.make_mesh_decode_step(cfg, mesh)
        tok = torch.as_tensor(tokens[:, PART_PROMPT:PART_PROMPT + 1])
        out_tok = []
        for t in range(PART_DECODE):
            log.armed = True
            lg, cache = decode(placed, cache, tok, PART_PROMPT + t)
            log.armed = False
            logits.append(lg.full_tensor())
            tok = logits[-1].argmax(-1).to(torch.int32)
            out_tok.append(tok)
        serve = {"budget": budget, "gathers": len(log.sizes),
                 "peak": log.peak - start,
                 "largest": max(log.sizes, default=0), "dtensor": log.dtensor,
                 "cache_local": [list(t.to_local().shape)
                                 for t in cache.values()]}
        with open(f"{d}/log_{i}_{rank}.json", "w") as f:
            json.dump({"train": train, "serve": serve}, f)
        if rank == 0:
            _save_tree(f"{d}/out_{i}.npz", {"params": gp, "m": gm},
                       loss=float(m["loss"]),
                       logits=torch.stack(logits).float().numpy(),
                       tokens=torch.cat(out_tok, 1).numpy())
    pod_step(rank, d)


def pod_step(rank, d):
    """PART_CASES[0]'s train step on a 2 x 2 x 2 (pod, data, model) mesh,
    the dp axes two deep as on the multi-pod mesh: rank 0 writes the
    gathered params and the loss to ``pod.npz``; every rank its counts
    to ``pod_<rank>.json``."""
    import json

    from repro_torch.convert import from_jax_params
    from repro_torch.launch.mesh import compat_mesh
    from repro_torch.optim import adam, constant_schedule
    from repro_torch.parallel import sharding as sh
    from repro_torch.roofline import dispatch
    from repro_torch.train import steps

    cfg = part_case(*PART_CASES[0])
    raw = dict(np.load(f"{d}/in_0.npz"))
    tokens = raw.pop("batch_tokens")
    full = from_jax_params(_tree_from_flat(raw))
    mesh = compat_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    specs = sh.param_specs(cfg, full, mesh)
    placed = sh.place(full, specs, mesh)
    opt = adam(constant_schedule(1e-3), grad_clip=1.0)
    state = sh.place_state(opt.init(full), specs, mesh)
    with dispatch.DispatchCounter() as c:
        p, _, m = steps.make_mesh_train_step(cfg, opt, mesh)(
            placed, state, {"tokens": tokens}, 0)
    with open(f"{d}/pod_{rank}.json", "w") as f:
        json.dump({"dot_flops": c.dot_flops,
                   "coll": {k: list(v) for k, v in c.coll_detail.items()}},
                  f)
    gp = sh.gather(p)
    if rank == 0:
        _save_tree(f"{d}/pod.npz", gp, loss=float(m["loss"]))


# tests/test_torch_partitioned_moe.py: (arch, compute dtype, MoE config
# changes) on a 2 x 4 mesh, FFN density 0.5 at block 32 (the experts,
# the shared experts and the dense first layer's MLP sparse): reduced
# qwen3-moe (8 experts, 2 a model rank; its 2 kv heads replicated), with
# 6 experts (replicated: the axis does not divide them), reduced
# deepseek-v2-lite (MLA's 4 heads split, its dense first layer, shared
# experts), and qwen3-moe with a dispatch group of 128 tokens, which
# spans both data ranks' rows, at a capacity factor of 0.5 (choices
# dropped)
MOE_CASES = [("qwen3-moe-30b-a3b", "float32", {}),
             ("qwen3-moe-30b-a3b", "bfloat16", {}),
             ("qwen3-moe-30b-a3b", "float32", {"num_experts": 6}),
             ("qwen3-moe-30b-a3b", "bfloat16", {"num_experts": 6}),
             ("deepseek-v2-lite-16b", "float32", {}),
             ("deepseek-v2-lite-16b", "bfloat16", {}),
             ("qwen3-moe-30b-a3b", "float32",
              {"group_size": 128, "capacity_factor": 0.5})]
SPANNING = len(MOE_CASES) - 1


def moe_case(arch, dtype, changes):
    """The reduced config of one MoE case (fp32 params)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.core.sparsity import SparsityConfig
    cfg = registry.get(arch).reduced().with_sparsity(
        SparsityConfig(density=0.5, block=32, where="ffn"))
    return dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(
        cfg.moe, **changes))


class RouteLog:
    """Inside ``with``: each MoE layer call's (pos, keep) while
    ``armed``, stacked and flattened to [2, tokens, K, experts]
    (``models/moe._dispatch_combine``'s arguments)."""

    def __init__(self):
        self.calls, self.armed = [], True

    def __enter__(self):
        from repro_torch.models import moe
        orig, log = moe._dispatch_combine, self

        def spy(top_p, pos, keep, C):
            if log.armed:
                K, E = pos.shape[-2:]
                log.calls.append(
                    np.stack([pos.detach().reshape(-1, K, E).numpy(),
                              keep.detach().reshape(-1, K, E).numpy()]))
            return orig(top_p, pos, keep, C)
        self._orig, moe._dispatch_combine = orig, spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._dispatch_combine = self._orig


def _counts(c):
    return {"dot_flops": c.dot_flops,
            "coll": {k: list(v) for k, v in c.coll_detail.items()}}


def moe_partitioned_run(rank, d):
    """Each MOE_CASES case on a 2 x 4 mesh from the reference's carried
    weights (``in_<case>.npz``), as ``partitioned_run`` runs PART_CASES:
    one two-pass Adam step (clip 1.0) counted under ``DispatchCounter``,
    a prefill of the first PART_PROMPT tokens padded to PART_S and
    PART_DECODE greedy decode steps, the first counted.  Each rank writes
    its routing (``RouteLog``: the train step's forward, the prefill,
    the decode steps) to ``route_<case>_<rank>.npz`` and its gather log,
    counts and held bytes to ``log_<case>_<rank>.json``; rank 0 writes
    the gathered params, Adam's m, the loss and aux, the logits and the
    tokens to ``out_<case>.npz``.  The spanning case also runs today's
    gathered mesh step (``make_gathered_mesh_train_step``) and the
    partitioned step at 2 microbatches (its params to ``mb2.npz``)."""
    import json

    from repro_torch.convert import from_jax_params
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import adam, constant_schedule
    from repro_torch.parallel import partition
    from repro_torch.parallel import sharding as sh
    from repro_torch.roofline import dispatch
    from repro_torch.train import steps

    mesh = make_local_mesh(2, 4, "cpu")
    log = GatherLog()
    with RouteLog() as route:
        route.armed = False
        for i, case in enumerate(MOE_CASES):
            cfg = moe_case(*case)
            raw = dict(np.load(f"{d}/in_{i}.npz"))
            tokens = raw.pop("batch_tokens")
            full = from_jax_params(_tree_from_flat(raw))
            specs = sh.param_specs(cfg, full, mesh)
            placed = sh.place(full, specs, mesh)
            opt = adam(constant_schedule(1e-3), grad_clip=1.0)
            state = sh.place_state(opt.init(full), specs, mesh)
            budget = unit_budget(partition.local_tree(placed), specs, mesh)
            step = steps.make_mesh_train_step(cfg, opt, mesh)
            log.sizes, log.peak, log.dtensor = [], log.live, []
            start = log.live
            route.calls = []
            log.armed = route.armed = True
            with dispatch.DispatchCounter() as c:
                p, s, m = step(placed, state, {"tokens": tokens}, 0)
            log.armed = route.armed = False
            train = dict(_counts(c), gathers=len(log.sizes),
                         largest=max(log.sizes), peak=log.peak - start,
                         budget=budget, dtensor=log.dtensor,
                         held={"params": sh.held_bytes(placed)[0],
                               "opt_state": sh.held_bytes(state)[0]},
                         after={"params": sh.held_bytes(p)[0],
                                "opt_state": sh.held_bytes(s)[0]})
            n_moe = cfg.n_layers - cfg.moe.first_dense_layers
            routes = {"train": route.calls[:n_moe]}
            gp, gm = sh.gather(p), sh.gather(s["m"])
            extra = {}
            if i == SPANNING:
                gathered = steps.make_gathered_mesh_train_step(cfg, opt,
                                                               mesh)
                _, _, got = gathered(placed, state, {"tokens": tokens}, 0)
                extra = {"gathered_loss": float(got["loss"]),
                         "gathered_aux": float(got["aux"])}
                p2, _, got = steps.make_mesh_train_step(cfg, opt, mesh, 2)(
                    placed, state, {"tokens": tokens}, 0)
                gp2 = sh.gather(p2)
                extra.update(mb2_loss=float(got["loss"]),
                             mb2_aux=float(got["aux"]))
            prompt = tokens.copy()
            prompt[:, PART_PROMPT:] = 0
            log.sizes, log.peak, log.dtensor = [], log.live, []
            start = log.live
            route.calls = []
            log.armed = route.armed = True
            lg, cache, _ = steps.make_mesh_prefill_step(cfg, mesh)(
                placed, {"tokens": prompt})
            log.armed = False
            logits = [lg.full_tensor()]
            decode = steps.make_mesh_decode_step(cfg, mesh)
            tok = torch.as_tensor(tokens[:, PART_PROMPT:PART_PROMPT + 1])
            out_tok, held_c = [], sh.held_bytes(cache)[0]
            for t in range(PART_DECODE):
                log.armed = True
                with dispatch.DispatchCounter() as c:
                    lg, cache = decode(placed, cache, tok, PART_PROMPT + t)
                log.armed = False
                if t == 0:
                    dec = dict(_counts(c), held={
                        "params": sh.held_bytes(placed)[0], "cache": held_c,
                        "logits": sh.held_bytes(lg)[0]})
                logits.append(lg.full_tensor())
                tok = logits[-1].argmax(-1).to(torch.int32)
                out_tok.append(tok)
            route.armed = False
            routes["serve"] = route.calls
            serve = {"budget": budget, "gathers": len(log.sizes),
                     "peak": log.peak - start,
                     "largest": max(log.sizes, default=0),
                     "dtensor": log.dtensor,
                     "cache_local": {k: list(t.to_local().shape)
                                     for k, t in _cache_items(cache)}}
            np.savez(f"{d}/route_{i}_{rank}.npz",
                     **{f"{k}_{j}": a for k, v in routes.items()
                        for j, a in enumerate(v)})
            with open(f"{d}/log_{i}_{rank}.json", "w") as f:
                json.dump({"train": train, "serve": serve, "decode": dec}, f)
            if rank == 0:
                if i == SPANNING:
                    _save_tree(f"{d}/mb2.npz", gp2)
                _save_tree(f"{d}/out_{i}.npz", {"params": gp, "m": gm},
                           loss=float(m["loss"]), aux=float(m["aux"]),
                           logits=torch.stack(logits).float().numpy(),
                           tokens=torch.cat(out_tok, 1).numpy(), **extra)


def _cache_items(cache, prefix=""):
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _cache_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# tests/test_torch_partitioned_ssm.py: (arch, compute dtype, config
# changes) on a 2 x 4 mesh, FFN density 0.5 at block 32: reduced
# falcon-mamba (d_inner 256: in_proj's 16 output blocks 4 a model rank,
# xs on ranks 0-1 and z on ranks 2-3), reduced zamba2 at two super-blocks
# (the shared block run twice; 8 heads, 2 a rank, 64 channels, and
# in_xbc's 384 columns 96 a rank, across the head boundary) and at one
# super-block with d_state 48 (in_xbc's 11 output blocks do not divide
# the axis: replicated, computed whole on every rank and cut to the
# conv's 88 columns)
SSM_CASES = [("falcon-mamba-7b", "float32", {}),
             ("falcon-mamba-7b", "bfloat16", {}),
             ("zamba2-2.7b", "float32", {"n_layers": 4}),
             ("zamba2-2.7b", "bfloat16", {"n_layers": 4}),
             ("zamba2-2.7b", "float32", {"ssm_state": 48}),
             ("zamba2-2.7b", "bfloat16", {"ssm_state": 48})]


def ssm_case(arch, dtype, changes):
    """The reduced config of one ssm, hybrid or vlm case (fp32 params)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.core.sparsity import SparsityConfig
    cfg = registry.get(arch).reduced().with_sparsity(
        SparsityConfig(density=0.5, block=32, where="ffn"))
    return dataclasses.replace(cfg, dtype=dtype, **changes)


def ssm_partitioned_run(rank, d):
    """Each SSM_CASES case on a 2 x 4 mesh from the reference's carried
    weights (``in_<case>.npz``), as ``moe_partitioned_run`` runs its
    cases: one two-pass Adam step (clip 1.0) and the first decode step
    counted under ``DispatchCounter``, a prefill of the first PART_PROMPT
    tokens padded to PART_S and PART_DECODE greedy decode steps.  Every
    rank writes its gather log, counts, held bytes and cache shard shapes
    to ``log_<case>_<rank>.json``; rank 0 writes the gathered params,
    Adam's m, the loss, the logits and the tokens to ``out_<case>.npz``."""
    import json

    from repro_torch.convert import from_jax_params
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import adam, constant_schedule
    from repro_torch.parallel import partition
    from repro_torch.parallel import sharding as sh
    from repro_torch.roofline import dispatch
    from repro_torch.train import steps

    mesh = make_local_mesh(2, 4, "cpu")
    log = GatherLog()
    for i, case in enumerate(SSM_CASES):
        cfg = ssm_case(*case)
        raw = dict(np.load(f"{d}/in_{i}.npz"))
        tokens = raw.pop("batch_tokens")
        full = from_jax_params(_tree_from_flat(raw))
        specs = sh.param_specs(cfg, full, mesh)
        placed = sh.place(full, specs, mesh)
        opt = adam(constant_schedule(1e-3), grad_clip=1.0)
        state = sh.place_state(opt.init(full), specs, mesh)
        budget = unit_budget(partition.local_tree(placed), specs, mesh)
        step = steps.make_mesh_train_step(cfg, opt, mesh)
        log.sizes, log.peak, log.dtensor = [], log.live, []
        start = log.live
        log.armed = True
        with dispatch.DispatchCounter() as c:
            p, s, m = step(placed, state, {"tokens": tokens}, 0)
        log.armed = False
        train = dict(_counts(c), gathers=len(log.sizes),
                     largest=max(log.sizes), peak=log.peak - start,
                     budget=budget, dtensor=log.dtensor,
                     held={"params": sh.held_bytes(placed)[0],
                           "opt_state": sh.held_bytes(state)[0]},
                     after={"params": sh.held_bytes(p)[0],
                            "opt_state": sh.held_bytes(s)[0]})
        gp, gm = sh.gather(p), sh.gather(s["m"])
        prompt = tokens.copy()
        prompt[:, PART_PROMPT:] = 0
        log.sizes, log.peak, log.dtensor = [], log.live, []
        start = log.live
        log.armed = True
        lg, cache, _ = steps.make_mesh_prefill_step(cfg, mesh)(
            placed, {"tokens": prompt})
        log.armed = False
        logits = [lg.full_tensor()]
        decode = steps.make_mesh_decode_step(cfg, mesh)
        tok = torch.as_tensor(tokens[:, PART_PROMPT:PART_PROMPT + 1])
        out_tok, held_c = [], sh.held_bytes(cache)[0]
        for t in range(PART_DECODE):
            log.armed = True
            with dispatch.DispatchCounter() as c:
                lg, cache = decode(placed, cache, tok, PART_PROMPT + t)
            log.armed = False
            if t == 0:
                dec = dict(_counts(c), held={
                    "params": sh.held_bytes(placed)[0], "cache": held_c,
                    "logits": sh.held_bytes(lg)[0]})
            logits.append(lg.full_tensor())
            tok = logits[-1].argmax(-1).to(torch.int32)
            out_tok.append(tok)
        serve = {"budget": budget, "gathers": len(log.sizes),
                 "peak": log.peak - start,
                 "largest": max(log.sizes, default=0),
                 "dtensor": log.dtensor,
                 "cache_local": {k: list(t.to_local().shape)
                                 for k, t in _cache_items(cache)}}
        with open(f"{d}/log_{i}_{rank}.json", "w") as f:
            json.dump({"train": train, "serve": serve, "decode": dec}, f)
        if rank == 0:
            _save_tree(f"{d}/out_{i}.npz", {"params": gp, "m": gm},
                       loss=float(m["loss"]),
                       logits=torch.stack(logits).float().numpy(),
                       tokens=torch.cat(out_tok, 1).numpy())


# tests/test_torch_partitioned_vlm.py: (arch, compute dtype, config
# changes) on a 2 x 4 mesh, FFN density 0.5 at block 32: reduced llava
# (4 heads) at a window of VLM_WINDOW, its 8 patches ahead of VLM_S - 8
# tokens, so that the prefill's ring of 12 slots (3 a model rank) holds
# only the last 12 of its 36 positions and the first decode step wraps
# it again (position 36 at slot 0); its 2 kv heads replicated over
# "model" (k / v projected on the rank's positions and gathered), and 4
# kv heads, one a model rank
VLM_S, VLM_WINDOW = 36, 12
VLM_CASES = [("llava-next-mistral-7b", "float32", {"window": VLM_WINDOW}),
             ("llava-next-mistral-7b", "bfloat16", {"window": VLM_WINDOW}),
             ("llava-next-mistral-7b", "float32",
              {"window": VLM_WINDOW, "kv_heads": 4}),
             ("llava-next-mistral-7b", "bfloat16",
              {"window": VLM_WINDOW, "kv_heads": 4})]


def vlm_partitioned_run(rank, d):
    """Each VLM_CASES case on a 2 x 4 mesh from the reference's carried
    weights and batch (``in_<case>.npz``: patches and tokens), as
    ``ssm_partitioned_run`` runs its cases: one two-pass Adam step (clip
    1.0) and the first decode step counted under ``DispatchCounter``, a
    prefill of the whole batch (P + S = VLM_S positions) and PART_DECODE
    greedy decode steps from position VLM_S, the first fed the prefill's
    pick.  Every rank writes its gather log, counts, held bytes and
    cache shard shapes to ``log_<case>_<rank>.json`` and its ring after
    the prefill to ``ring_<case>_<rank>.npz``; rank 0 writes the
    gathered params, Adam's m, the loss, the logits and the fed tokens
    to ``out_<case>.npz``."""
    import json

    from repro_torch.convert import from_jax_params
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import adam, constant_schedule
    from repro_torch.parallel import partition
    from repro_torch.parallel import sharding as sh
    from repro_torch.roofline import dispatch
    from repro_torch.train import steps

    mesh = make_local_mesh(2, 4, "cpu")
    log = GatherLog()
    for i, case in enumerate(VLM_CASES):
        cfg = ssm_case(*case)
        raw = dict(np.load(f"{d}/in_{i}.npz"))
        batch = {"tokens": raw.pop("batch_tokens"),
                 "patches": raw.pop("batch_patches")}
        full = from_jax_params(_tree_from_flat(raw))
        specs = sh.param_specs(cfg, full, mesh)
        placed = sh.place(full, specs, mesh)
        opt = adam(constant_schedule(1e-3), grad_clip=1.0)
        state = sh.place_state(opt.init(full), specs, mesh)
        budget = unit_budget(partition.local_tree(placed), specs, mesh)
        step = steps.make_mesh_train_step(cfg, opt, mesh)
        log.sizes, log.peak, log.dtensor = [], log.live, []
        start = log.live
        log.armed = True
        with dispatch.DispatchCounter() as c:
            p, s, m = step(placed, state, batch, 0)
        log.armed = False
        train = dict(_counts(c), gathers=len(log.sizes),
                     largest=max(log.sizes), peak=log.peak - start,
                     budget=budget, dtensor=log.dtensor,
                     held={"params": sh.held_bytes(placed)[0],
                           "opt_state": sh.held_bytes(state)[0]},
                     after={"params": sh.held_bytes(p)[0],
                            "opt_state": sh.held_bytes(s)[0]})
        gp, gm = sh.gather(p), sh.gather(s["m"])
        log.sizes, log.peak, log.dtensor = [], log.live, []
        start = log.live
        log.armed = True
        lg, cache, npos = steps.make_mesh_prefill_step(cfg, mesh)(
            placed, batch)
        log.armed = False
        ring = {k: t.to_local().clone() for k, t in _cache_items(cache)}
        logits = [lg.full_tensor()]
        decode = steps.make_mesh_decode_step(cfg, mesh)
        held_c = sh.held_bytes(cache)[0]
        fed = []
        for t in range(PART_DECODE):
            tok = logits[-1].argmax(-1).to(torch.int32)
            fed.append(tok)
            log.armed = True
            with dispatch.DispatchCounter() as c:
                lg, cache = decode(placed, cache, tok, npos + t)
            log.armed = False
            if t == 0:
                dec = dict(_counts(c), held={
                    "params": sh.held_bytes(placed)[0], "cache": held_c,
                    "logits": sh.held_bytes(lg)[0]})
            logits.append(lg.full_tensor())
        serve = {"budget": budget, "gathers": len(log.sizes),
                 "peak": log.peak - start, "npos": npos,
                 "largest": max(log.sizes, default=0),
                 "dtensor": log.dtensor,
                 "cache_local": {k: list(t.to_local().shape)
                                 for k, t in _cache_items(cache)}}
        np.savez(f"{d}/ring_{i}_{rank}.npz",
                 **{k: v.float().numpy() for k, v in ring.items()})
        with open(f"{d}/log_{i}_{rank}.json", "w") as f:
            json.dump({"train": train, "serve": serve, "decode": dec}, f)
        if rank == 0:
            _save_tree(f"{d}/out_{i}.npz", {"params": gp, "m": gm},
                       loss=float(m["loss"]),
                       logits=torch.stack(logits).float().numpy(),
                       tokens=torch.cat(fed, 1).numpy())


# tests/test_torch_partitioned_audio.py: (compute dtype, config changes,
# positions) on a 2 x 4 mesh on the "sp" strategy, FFN density 0.5 at
# block 32: reduced whisper-base (16 frames, 4 a model rank) on AUDIO_B
# rows of 64 positions (16 a model rank), in fp32 and bf16, and with the
# loss in chunks of 8 positions (two a rank); and on 66 positions, which
# the model axis does not divide (every position on every rank, the
# frames still split).  The prefill of AUDIO_PROMPT prompt tokens is
# padded to the positions, so the decode steps write positions 46-49,
# across model ranks 2 and 3 where the sequence splits
AUDIO_B, AUDIO_PROMPT = 8, 46
AUDIO_CASES = [("float32", {}, 64), ("bfloat16", {}, 64),
               ("float32", {"loss_chunk": 8}, 64), ("float32", {}, 66)]


def audio_case(dtype, changes):
    """The reduced whisper-base config of an audio case."""
    return ssm_case("whisper-base", dtype, changes)


def audio_partitioned_run(rank, d):
    """Each AUDIO_CASES case on a 2 x 4 mesh from the reference's carried
    weights and batch (``in_<case>.npz``: tokens and frames), as
    ``vlm_partitioned_run`` runs its cases: one two-pass Adam step (clip
    1.0) and the first decode step counted under ``DispatchCounter``, a
    prefill of the first AUDIO_PROMPT tokens padded to the case's
    positions and PART_DECODE greedy decode steps from position
    AUDIO_PROMPT.  Every
    rank writes its gather log, counts, held bytes and cache shard
    shapes to ``log_<case>_<rank>.json`` and its cache after the prefill
    to ``cache_<case>_<rank>.npz``; rank 0 writes the gathered params,
    Adam's m, the loss, the logits and the tokens to ``out_<case>.npz``."""
    import json

    from repro_torch.convert import from_jax_params
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import adam, constant_schedule
    from repro_torch.parallel import partition
    from repro_torch.parallel import sharding as sh
    from repro_torch.roofline import dispatch
    from repro_torch.train import steps

    mesh = make_local_mesh(2, 4, "cpu")
    log = GatherLog()
    for i, case in enumerate(AUDIO_CASES):
        cfg = audio_case(*case[:2])
        raw = dict(np.load(f"{d}/in_{i}.npz"))
        batch = {"tokens": raw.pop("batch_tokens"),
                 "frames": raw.pop("batch_frames")}
        full = from_jax_params(_tree_from_flat(raw))
        specs = sh.param_specs(cfg, full, mesh)
        placed = sh.place(full, specs, mesh)
        opt = adam(constant_schedule(1e-3), grad_clip=1.0)
        state = sh.place_state(opt.init(full), specs, mesh)
        budget = unit_budget(partition.local_tree(placed), specs, mesh)
        step = steps.make_mesh_train_step(cfg, opt, mesh)
        log.sizes, log.peak, log.dtensor = [], log.live, []
        start = log.live
        log.armed = True
        with dispatch.DispatchCounter() as c:
            p, s, m = step(placed, state, batch, 0)
        log.armed = False
        train = dict(_counts(c), gathers=len(log.sizes),
                     largest=max(log.sizes), peak=log.peak - start,
                     budget=budget, dtensor=log.dtensor,
                     held={"params": sh.held_bytes(placed)[0],
                           "opt_state": sh.held_bytes(state)[0]},
                     after={"params": sh.held_bytes(p)[0],
                            "opt_state": sh.held_bytes(s)[0]})
        gp, gm = sh.gather(p), sh.gather(s["m"])
        prompt = dict(batch, tokens=batch["tokens"].copy())
        prompt["tokens"][:, AUDIO_PROMPT:] = 0
        log.sizes, log.peak, log.dtensor = [], log.live, []
        start = log.live
        log.armed = True
        lg, cache, npos = steps.make_mesh_prefill_step(cfg, mesh)(
            placed, prompt)
        log.armed = False
        kept = {k: t.to_local().clone() for k, t in _cache_items(cache)}
        logits = [lg.full_tensor()]
        decode = steps.make_mesh_decode_step(cfg, mesh)
        tok = torch.as_tensor(batch["tokens"][:, AUDIO_PROMPT:
                                              AUDIO_PROMPT + 1])
        out_tok, held_c = [], sh.held_bytes(cache)[0]
        for t in range(PART_DECODE):
            log.armed = True
            with dispatch.DispatchCounter() as c:
                lg, cache = decode(placed, cache, tok, AUDIO_PROMPT + t)
            log.armed = False
            if t == 0:
                dec = dict(_counts(c), held={
                    "params": sh.held_bytes(placed)[0], "cache": held_c,
                    "logits": sh.held_bytes(lg)[0]})
            logits.append(lg.full_tensor())
            tok = logits[-1].argmax(-1).to(torch.int32)
            out_tok.append(tok)
        serve = {"budget": budget, "gathers": len(log.sizes),
                 "peak": log.peak - start, "npos": npos,
                 "largest": max(log.sizes, default=0),
                 "dtensor": log.dtensor,
                 "cache_local": {k: list(t.to_local().shape)
                                 for k, t in _cache_items(cache)}}
        np.savez(f"{d}/cache_{i}_{rank}.npz",
                 **{k: v.float().numpy() for k, v in kept.items()})
        with open(f"{d}/log_{i}_{rank}.json", "w") as f:
            json.dump({"train": train, "serve": serve, "decode": dec}, f)
        if rank == 0:
            _save_tree(f"{d}/out_{i}.npz", {"params": gp, "m": gm},
                       loss=float(m["loss"]),
                       logits=torch.stack(logits).float().numpy(),
                       tokens=torch.cat(out_tok, 1).numpy())


# tests/test_torch_partitioned_fused.py: (arch, block, config changes) on
# a 2 x 4 mesh, fp32 compute and params, FFN density 0.5: reduced
# stablelm-3b at block 64 (wg / wi's 4 output blocks one a model rank,
# "col"; wo's 2 do not divide the axis, "rep"), reduced llava at its
# window of VLM_WINDOW (8 patches ahead of 28 tokens a row) and reduced
# falcon-mamba (in_proj's 16 and out_proj's 4 output blocks split), each
# through the fused steps of FUSED_OPTS, FUSED_STEPS of them
FUSED_CASES = [("stablelm-3b", 64, {}),
               ("llava-next-mistral-7b", 32, {"window": VLM_WINDOW}),
               ("falcon-mamba-7b", 32, {})]
FUSED_OPTS = ("adam_clip", "sgd_momentum")
FUSED_STEPS = 3


def fused_mesh_case(arch, block, changes):
    """The reduced config of one partitioned fused case."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.core.sparsity import SparsityConfig
    cfg = registry.get(arch).reduced().with_sparsity(
        SparsityConfig(density=0.5, block=block, where="ffn"))
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                               fused_update=True, **changes)


def fused_mesh_opt(kind):
    """The port's fused optimizer of a FUSED_OPTS kind."""
    from repro_torch.optim import constant_schedule, fused_adam, fused_sgd
    if kind == "adam_clip":
        return fused_adam(constant_schedule(1e-3), grad_clip=1.0)
    return fused_sgd(constant_schedule(3e-2), momentum=0.9)


def fused_mesh_batches(raw):
    """The FUSED_STEPS batches an ``in_<case>.npz`` holds (popped)."""
    out = []
    for j in range(FUSED_STEPS):
        b = {"tokens": raw.pop(f"batch{j}_tokens")}
        for k in ("patches", "frames"):
            if f"batch{j}_{k}" in raw:
                b[k] = raw.pop(f"batch{j}_{k}")
        out.append(b)
    return out


class JunctionGatherLog:
    """What a rank holds of fused junctions gathered over the dp axes
    (``partition.HeldJunction``'s weight, bias and slot gathers): their
    count, the most bytes alive at once and the bytes alive now."""

    def __init__(self):
        import weakref

        from repro_torch.parallel import partition
        self.count, self.live, self.peak = 0, 0, 0
        orig, log = partition.HeldJunction._gathered, self

        def spy(held, name):
            t = orig(held, name)
            if t is not None and t is not held.leaves.get(name):
                n = t.untyped_storage().nbytes()
                log.count += 1
                log.live += n
                log.peak = max(log.peak, log.live)
                weakref.finalize(t.untyped_storage(), log._free, n)
            return t
        partition.HeldJunction._gathered = spy

    def _free(self, n):
        self.live -= n


def junction_budget(local, specs, mesh, n_slots) -> tuple[int, int]:
    """(the largest fused junction's weight, bias and ``n_slots`` fp32
    slots gathered over the dp axes, the most slot bytes of one unit's
    junctions so gathered), over the layers, a MoE model's dense first
    layers and whisper's encoder layers: bytes."""
    from repro_torch.core import sparse_linear as sl
    from repro_torch.parallel import sharding as sh
    sizes = sh.axis_sizes(mesh)

    def dp(spec):
        n = 1
        for e in spec:
            for a in sh.spec_axes(e):
                n *= sizes[a] if a != "model" else 1
        return n

    def junctions(t, s):
        if isinstance(t, dict):
            if sl.is_sparse(t):
                yield t, s
            for k, v in t.items():
                if isinstance(v, (dict, list, tuple)):
                    yield from junctions(v, s[k])
        elif isinstance(t, (list, tuple)):
            for v, q in zip(t, s):
                yield from junctions(v, q)

    def own(j, s):
        tot = slots = 0
        for k in ("w", "b"):
            if k in j:
                g = j[k].numel() * dp(s[k])
                tot += g * j[k].element_size() + n_slots * 4 * g
                slots += n_slots * 4 * g
        return tot, slots

    one, unit = 0, 0
    stacks = [(local[k], specs[k]) for k in ("dense_layers", "layers")
              if k in local]
    if "encoder" in local:                  # whisper's encoder
        stacks.append((local["encoder"]["layers"],
                       specs["encoder"]["layers"]))
    for layers, lspecs in stacks:
        for lp, ls in zip(layers, lspecs):
            got = [own(j, s) for j, s in junctions(lp, ls)]
            one = max([one] + [a for a, _ in got])
            unit = max(unit, sum(b for _, b in got))
    return one, unit


def fused_partitioned_run(rank, d):
    """Each FUSED_CASES case through each FUSED_OPTS optimizer on a 2 x 4
    mesh, from the reference's carried weights and its FUSED_STEPS
    batches (``in_<case>.npz``), through ``fused_mesh_runs``."""
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(2, 4, "cpu")
    logs = (GatherLog(), JunctionGatherLog())
    for i, case in enumerate(FUSED_CASES):
        fused_mesh_runs(rank, d, mesh, i, fused_mesh_case(*case), FUSED_OPTS,
                        logs)


def fused_mesh_runs(rank, d, mesh, i, cfg, kinds, logs, blocks=None):
    """Case ``i`` (``cfg``) through each optimizer of ``kinds`` on
    ``mesh``, from the reference's carried weights and its FUSED_STEPS
    batches (``in_<i>.npz``): the fused steps through
    ``make_mesh_train_step``, the first counted under
    ``DispatchCounter`` and ``logs`` (a ``GatherLog`` and a
    ``JunctionGatherLog``), each rank's at-rest shards checked after
    every step; ``blocks`` (an ``ExpertOperandLog``) records the first
    step's expert update operands.  Every rank writes its logs to
    ``log_<i>_<opt>_<rank>.json`` (and the operands to
    ``blocks_<i>_<opt>_<rank>.npz``); rank 0 writes the gathered params
    and slots, the losses and the nonfinite counts to
    ``out_<i>_<opt>.npz``."""
    import contextlib
    import json

    from repro_torch.convert import from_jax_params
    from repro_torch.parallel import partition
    from repro_torch.parallel import sharding as sh
    from repro_torch.roofline import dispatch
    from repro_torch.train import steps
    from repro_torch.tree import tree_map

    log, jlog = logs
    raw = dict(np.load(f"{d}/in_{i}.npz"))
    batches = fused_mesh_batches(raw)
    full = from_jax_params(_tree_from_flat(raw))
    specs = sh.param_specs(cfg, full, mesh)
    for kind in kinds:
        opt = fused_mesh_opt(kind)
        placed = sh.place(tree_map(lambda t: t.clone(), full), specs, mesh)
        state = sh.place_state(opt.init(full), specs, mesh)
        local = partition.local_tree(placed)
        budget = unit_budget(local, specs, mesh)
        one, unit_slots = junction_budget(local, specs, mesh,
                                          len(opt.slot_keys()))
        held = {"params": sh.held_bytes(placed)[0],
                "opt_state": sh.held_bytes(state)[0]}
        step = steps.make_mesh_train_step(cfg, opt, mesh)
        losses, nonfinite, at_rest = [], [], []
        for j, batch in enumerate(batches):
            log.sizes, log.peak, log.dtensor = [], log.live, []
            start, jstart = log.live, jlog.live
            jlog.count, jlog.peak = 0, jlog.live
            log.armed = j == 0
            if blocks is not None:
                blocks.calls, blocks.armed = [], j == 0
            with (dispatch.DispatchCounter() if j == 0
                  else contextlib.nullcontext()) as c:
                placed, state, m = step(placed, state, batch, j)
            log.armed = False
            if blocks is not None:
                blocks.armed = False
                if j == 0:
                    blocks.save(f"{d}/blocks_{i}_{kind}_{rank}.npz")
            if j == 0:
                train = dict(
                    _counts(c), gathers=len(log.sizes),
                    largest=max(log.sizes), peak=log.peak - start,
                    budget=budget, dtensor=log.dtensor,
                    junction_gathers=jlog.count,
                    junction_peak=jlog.peak - jstart,
                    junction_left=jlog.live - jstart,
                    junction_budget=one, unit_slots=unit_slots,
                    held=held)
            losses.append(float(m["loss"]))
            nonfinite.append(float(m["nonfinite"]))
            at_rest.append(bool(
                shard_counts(placed, specs, mesh) and all(
                    shard_counts(state[k], specs, mesh)
                    for k in opt.slot_keys())))
        train["after"] = {"params": sh.held_bytes(placed)[0],
                          "opt_state": sh.held_bytes(state)[0]}
        train["at_rest"] = at_rest
        train["nonfinite"] = nonfinite
        gp = sh.gather(placed)
        slots = {k: sh.gather(state[k]) for k in opt.slot_keys()}
        with open(f"{d}/log_{i}_{kind}_{rank}.json", "w") as f:
            json.dump(train, f)
        if rank == 0:
            _save_tree(f"{d}/out_{i}_{kind}.npz", {"params": gp, **slots},
                       losses=np.asarray(losses),
                       nonfinite=np.asarray(nonfinite))


# tests/test_torch_partitioned_fused_moe.py: (arch, MoE config changes,
# the FUSED_OPTS it runs) on a 2 x 4 mesh, fp32, FFN density 0.5 at
# block 32, PART_B x PART_S a step: reduced qwen3-moe (8 experts, 2 a
# model rank), the same with 6 experts (replicated: "model" does not
# divide them), with a dispatch group of 128 tokens (it crosses both data
# ranks' rows) at capacity factor 0.5 (choices dropped), and reduced
# deepseek-v2-lite (MLA, its dense first layer, shared experts); then
# FOLD_CASE on a 4 x 2 mesh: FOLD_B x FOLD_S, 48 tokens a row group in
# groups of 64, so that the ranks' windows of whole groups are 64, 128,
# 128 and 64 tokens long
FUSED_MOE_CASES = [
    ("qwen3-moe-30b-a3b", {}, FUSED_OPTS),
    ("qwen3-moe-30b-a3b", {"num_experts": 6}, ("sgd_momentum",)),
    ("qwen3-moe-30b-a3b", {"group_size": 128, "capacity_factor": 0.5},
     ("adam_clip",)),
    ("deepseek-v2-lite-16b", {}, FUSED_OPTS)]
FOLD_CASE = ("qwen3-moe-30b-a3b", {}, ("sgd_momentum",))
FOLD_B, FOLD_S = 4, 48


def fused_moe_case(arch, changes):
    """The reduced config of one partitioned fused MoE case."""
    import dataclasses
    cfg = fused_mesh_case(arch, 32, {})
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            **changes))


class ExpertOperandLog:
    """While ``armed``: the operands each MoE expert junction's fused
    update sums over, in call order: the gate's (x, dh, g, u)
    (``bsm.update_gated_dw``) and wo's (h, dy) (``bsm.update_dw`` of
    more than one unit).  ``restore`` puts the kernels' entries back."""

    KEYS = {"gate": ("x", "dh", "g", "u"), "out": ("x", "dy")}

    def __init__(self):
        from repro_torch.kernels import block_sparse_matmul as bsm
        self.calls, self.armed = [], False
        self._orig = og, ou = bsm.update_gated_dw, bsm.update_dw
        log = self

        def gated(x, dh, idx, g, u, *a, **k):
            if log.armed:
                log.calls.append(("gate", [t.detach().float().clone()
                                           for t in (x, dh, g, u)]))
            return og(x, dh, idx, g, u, *a, **k)

        def plain(x, dy, *a, **k):
            if log.armed and x.shape[0] > 1:
                log.calls.append(("out", [t.detach().float().clone()
                                          for t in (x, dy)]))
            return ou(x, dy, *a, **k)
        bsm.update_gated_dw, bsm.update_dw = gated, plain

    def restore(self):
        from repro_torch.kernels import block_sparse_matmul as bsm
        bsm.update_gated_dw, bsm.update_dw = self._orig

    def arrays(self):
        """{"<call>_<kind>_<operand>": array} of the recorded calls."""
        return {f"{n}_{kind}_{k}": t.numpy()
                for n, (kind, ts) in enumerate(self.calls)
                for k, t in zip(self.KEYS[kind], ts)}

    def save(self, path):
        np.savez(path, **self.arrays())


def fused_moe_run(rank, d):
    """Each FUSED_MOE_CASES case through its optimizers on a 2 x 4 mesh,
    then FOLD_CASE (``in_fold.npz``) on a 4 x 2 mesh, through
    ``fused_mesh_runs``, each first step's expert update operands
    recorded (``ExpertOperandLog``)."""
    from repro_torch.launch.mesh import make_local_mesh
    logs = (GatherLog(), JunctionGatherLog())
    blocks = ExpertOperandLog()
    mesh = make_local_mesh(2, 4, "cpu")
    for i, (arch, changes, kinds) in enumerate(FUSED_MOE_CASES):
        fused_mesh_runs(rank, d, mesh, i, fused_moe_case(arch, changes),
                        kinds, logs, blocks)
    fold = make_local_mesh(4, 2, "cpu")
    fused_mesh_runs(rank, d, fold, "fold", fused_moe_case(*FOLD_CASE[:2]),
                    FOLD_CASE[2], logs, blocks)


# tests/test_torch_partitioned_fused_audio.py: (positions, config
# changes, the FUSED_OPTS it runs) of reduced whisper-base on a 2 x 4
# mesh on the "sp" strategy, fp32, FFN density 0.5 at block 32, PART_B
# rows a step: 64 positions (16 a model rank) and 16 frames (4 a model
# rank); 66 positions, which "model" does not divide (every position on
# every rank, the frames still split); and 64 positions with 18 frames,
# which it does not divide (the frames whole on every rank, as the
# production model's 1500 frames on 16)
FUSED_AUDIO_CASES = [(64, {}, FUSED_OPTS), (66, {}, ("sgd_momentum",)),
                     (64, {"enc_frames": 18}, ("adam_clip",))]


def fused_audio_case(changes):
    """The reduced whisper-base config of one partitioned fused case."""
    return fused_mesh_case("whisper-base", 32, changes)


def fused_audio_run(rank, d):
    """Each FUSED_AUDIO_CASES case through its optimizers on a 2 x 4 mesh,
    through ``fused_mesh_runs``."""
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(2, 4, "cpu")
    logs = (GatherLog(), JunctionGatherLog())
    for i, case in enumerate(FUSED_AUDIO_CASES):
        fused_mesh_runs(rank, d, mesh, i, fused_audio_case(case[1]), case[2],
                        logs)
