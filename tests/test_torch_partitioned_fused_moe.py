"""The moe family's fused BP+UP train step on the partitioned mesh route
(``steps.make_mesh_train_step``: each rank's experts updated over every
row group's capacity slots, ``partition.Partition._fused_experts``; the
shared experts and deepseek's dense first layer through
``partition.HeldJunction`` as dense MLPs) against one rank, the JAX
reference and the dry run's reckoning, on the CPU.

* 8 gloo ranks on a 2 x 4 (data x model) mesh run ``FUSED_MOE_CASES``
  (tests/torch_mesh_workers.py), fp32, FFN density 0.5 at block 32, 4 x
  32 a step: reduced qwen3-moe (8 experts top-2, 2 a model rank), the
  same with 6 experts (replicated: every model rank runs them all on the
  same rows, its dh partial and all-reduced over "model"), with a
  dispatch group of 128 tokens, which crosses both data ranks' rows (each
  rank runs its window of whole groups, the other row group's slots
  zero), at capacity factor 0.5 (choices dropped), and reduced
  deepseek-v2-lite (MLA, its dense first layer run once and kept, shared
  experts).  Each takes 3 steps of clipped fused Adam (lr 1e-3, clip 1.0)
  and / or fused SGD with momentum (lr 3e-2, 0.9), on weights the
  reference made, carried through numpy:
  - the losses, the gathered params and slots against the port's
    one-rank fused step and the reference's single-device fused step
    (engine "pallas", its kernels in interpret mode): losses to 1e-5,
    params and slots to rtol 5e-4 / atol 5e-5 (``noise_slack`` summed
    over the steps);
  - ``nonfinite`` equals the one-rank step's count, 0 here;
  - every rank holds at rest only its shards, after each step; it
    gathers one unit at a time, and no gathered fused junction (the
    shared experts', the dense layer's MLP) outlives its backward;
  - in the first step, each rank's expert update operands (the gate's
    x, dh, g, u and wo's h, dy) against the one-rank step's slots of the
    rank's experts, [E_rank, G * C, d], slot for slot: the one-rank zero
    slots exactly zero, the others within tolerance (a duplicated or
    misordered slot fails);
  - the collectives, dot FLOPs and held bytes of every rank's first step
    equal ``launch/dryrun.count_cell``'s reckoning on
    ``AbstractMesh((2, 4))``.
* ``FOLD_CASE`` on a 4 x 2 mesh (4 x 48 a step: 48 tokens a row group,
  groups of 64, so the ranks' windows are 64, 128, 128 and 64 tokens):
  one fused SGD step's expert operands against the one-rank slots as
  above, and its params, slots and loss against the one-rank step.
* The fold alone (``partition.group_window``, ``HeldJunction.windowed``,
  ``partition.fold_windows``): the four unequal windows' dispatched
  blocks, padded and concatenated in rank order as the all-gather does,
  fold onto the one-rank dispatch block bit for bit.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.configs import registry as jreg

from repro_torch.models import moe
from repro_torch.parallel import partition
from repro_torch.train import steps
from torch_fused_mesh_checks import check_at_rest, check_collectives, \
    check_gathers, check_nonfinite, check_parity, one_rank, rank_out, \
    reference_cfg, write_inputs
from torch_mesh_workers import FOLD_B, FOLD_CASE, FOLD_S, \
    FUSED_MOE_CASES, PART_B, PART_S, ExpertOperandLog, fused_mesh_opt, \
    fused_moe_case, fused_moe_run, join_ranks, start_ranks

RUNS = [(i, kind) for i, case in enumerate(FUSED_MOE_CASES)
        for kind in case[2]]
IDS = [f"{FUSED_MOE_CASES[i][0]}-{i}-{kind}" for i, kind in RUNS]
BLOCK_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(case):
    arch, changes, _ = case
    tcfg = fused_moe_case(arch, changes)
    jcfg = jreg.get(arch).reduced()
    jcfg = reference_cfg(jcfg, tcfg, moe=dataclasses.replace(jcfg.moe,
                                                             **changes))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The reference's weights and batches of each case (``in_<i>.npz``,
    ``in_fold.npz``), and the 8 ranks started on them."""
    d = tmp_path_factory.mktemp("partitioned_fused_moe")
    for i, case in enumerate(FUSED_MOE_CASES):
        write_inputs(d / f"in_{i}.npz", _cfgs(case)[0], PART_B, PART_S)
    write_inputs(d / "in_fold.npz", _cfgs(FOLD_CASE)[0], FOLD_B, FOLD_S)
    return d, start_ranks(fused_moe_run, 8, str(d))


@pytest.fixture(scope="module")
def one_ranks(inputs):
    """Per run: the port's one-rank and the reference's fused steps
    (``torch_fused_mesh_checks.one_rank``) with the port's first step's
    expert operands, made while the ranks run; the fold case's port
    one-rank steps under the key "fold"."""
    d, _ = inputs
    got = {}
    blocks = ExpertOperandLog()
    try:
        for i, kind in RUNS:
            jcfg, tcfg = _cfgs(FUSED_MOE_CASES[i])
            runs = one_rank(d / f"in_{i}.npz", jcfg, tcfg, kind, blocks)
            got[(i, kind)] = runs + (blocks.kept,)
        jcfg, tcfg = _cfgs(FOLD_CASE)
        port, _, _ = one_rank(d / "in_fold.npz", jcfg, tcfg,
                              FOLD_CASE[2][0], blocks, reference=False)
        got["fold"] = (port, blocks.kept)
    finally:
        blocks.restore()
    return got


@pytest.fixture(scope="module")
def runs(inputs, one_ranks):
    """The directory of the 8 ranks' results, once they have ended."""
    d, ctx = inputs
    join_ranks(ctx)
    return d


# ------------------------------------------------------------ the cases
@pytest.mark.parametrize("i", range(len(FUSED_MOE_CASES)))
def test_case_takes_the_partitioned_fused_route(i):
    arch, changes, kinds = FUSED_MOE_CASES[i]
    cfg = fused_moe_case(arch, changes)
    for kind in kinds:
        opt = fused_mesh_opt(kind)
        assert steps.fused_update_eligible(cfg, opt)[0]
        assert steps.partitioned(cfg, opt)
    E, m = cfg.moe.num_experts, 4
    assert (E % m == 0) == ("num_experts" not in changes)
    if "group_size" in changes:     # its groups cross the data ranks
        assert (PART_B // 2 * PART_S) % cfg.moe.group_size


# ------------------------------------------------------------ 8 ranks
@pytest.mark.parametrize("i,kind", RUNS, ids=IDS)
def test_fused_steps_match_one_rank_and_reference(i, kind, runs, one_ranks):
    out, _ = rank_out(runs, i, kind)
    port, ref, slack, _ = one_ranks[(i, kind)]
    check_parity(out, (port, ref), kind, slack)


@pytest.mark.parametrize("i,kind", RUNS, ids=IDS)
def test_nonfinite_equals_one_rank(i, kind, runs, one_ranks):
    out, logs = rank_out(runs, i, kind)
    check_nonfinite(out, logs, one_ranks[(i, kind)][0][3])


@pytest.mark.parametrize("i,kind", RUNS, ids=IDS)
def test_each_rank_holds_only_its_shards_at_rest(i, kind, runs):
    check_at_rest(rank_out(runs, i, kind)[1])


@pytest.mark.parametrize("i,kind", RUNS, ids=IDS)
def test_each_rank_gathers_one_unit_at_a_time(i, kind, runs):
    """qwen3-moe's fused junctions are its experts, which nothing splits
    over the dp axes: no fused junction is gathered; deepseek's shared
    experts and dense first layer's MLP (run once and kept) are."""
    dense = FUSED_MOE_CASES[i][0] == "deepseek-v2-lite-16b"
    check_gathers(rank_out(runs, i, kind)[1], junction_gathers=dense)


@pytest.mark.parametrize("i,kind", RUNS, ids=IDS)
def test_collectives_equal_reckoning(i, kind, runs):
    arch, changes, _ = FUSED_MOE_CASES[i]
    check_collectives(rank_out(runs, i, kind)[1],
                      fused_moe_case(arch, changes), PART_B, PART_S, kind)


def _rank_experts(cfg, r: int, model: int):
    """The experts rank ``r`` of a (data, model) mesh holds."""
    E = cfg.moe.num_experts
    if E % model:
        return slice(0, E)
    El = E // model
    return slice(r % model * El, (r % model + 1) * El)


def _check_blocks(d, tag, kind, want, cfg, model):
    """Every rank's first step's expert update operands against the
    one-rank step's slots of its experts (``want``: ``ExpertOperandLog``
    arrays).  A rank's loss is the mean over its row group's rows, so its
    dh and dy are the row groups' count times the one-rank step's (the
    hyp row's gs column carries the inverse)."""
    n_rows = 8 // model
    for r in range(8):
        got = dict(np.load(d / f"blocks_{tag}_{kind}_{r}.npz"))
        assert got.keys() == want.keys() and got
        ex = _rank_experts(cfg, r, model)
        for key, g in got.items():
            w = want[key][ex]
            n, call, operand = key.split("_")
            if operand in ("dh", "dy"):
                g = g / n_rows
            zero = (want[f"{n}_{call}_x"][ex] == 0).all(-1)
            assert g.shape == w.shape, (r, key)
            assert (g[zero] == 0).all(), (r, key)
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(
                g[~zero], w[~zero], rtol=BLOCK_TOL["rtol"],
                atol=BLOCK_TOL["atol"] * scale, err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("i,kind", RUNS, ids=IDS)
def test_expert_operands_are_the_one_rank_slots(i, kind, runs, one_ranks):
    cfg = fused_moe_case(*FUSED_MOE_CASES[i][:2])
    want = one_ranks[(i, kind)][3]
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    assert sorted({k.split("_x")[0] for k in want if k.endswith("_x")}) == \
        sorted(f"{n}_{k}" for n in range(2 * n_moe)
               for k in ("gate", "out") if (n % 2 == 0) == (k == "out"))
    _check_blocks(runs, i, kind, want, cfg, 4)


# ------------------------------------------------- four row groups
def test_fold_case_windows_are_unequal():
    cfg = fused_moe_case(*FOLD_CASE[:2])
    T, g = FOLD_B * FOLD_S // 4, cfg.moe.group_size
    wins = [partition.group_window(q * T, T, g) for q in range(4)]
    assert [n for _, n in wins] == [64, 128, 128, 64]


def test_fold_case_operands_are_the_one_rank_slots(runs, one_ranks):
    cfg = fused_moe_case(*FOLD_CASE[:2])
    _check_blocks(runs, "fold", FOLD_CASE[2][0], one_ranks["fold"][1], cfg,
                  2)


def test_fold_case_matches_one_rank(runs, one_ranks):
    kind = FOLD_CASE[2][0]
    out, logs = rank_out(runs, "fold", kind)
    check_parity(out, [one_ranks["fold"][0]], kind)
    check_nonfinite(out, logs, one_ranks["fold"][0][3])
    check_at_rest(logs)


def _dispatched(x, top_p, top_e, E, C, g, o=None, T=None):
    """The [E, groups * C, d] block of dispatched slots of ``x`` [tokens,
    d] routed by ``top_e`` / ``top_p`` (every token's) in groups of
    ``g``; with ``o`` and ``T`` the window of whole groups that tokens
    [o, o + T) lie in, other tokens zero (``moe.moe_apply_tp``'s
    windowed dispatch)."""
    N, K = top_e.shape
    if o is None:
        o, T = 0, N
    a, n = partition.group_window(o, T, g)
    pos, keep = moe._slots(moe._one_hot(top_e[a:a + n].reshape(
        n // g, g, K), E), C)
    pos, keep = (t.reshape(n, K, E)[o - a:o - a + T][None]
                 for t in (pos, keep))
    disp, _ = moe._dispatch_combine(top_p[o:o + T][None], pos, keep, C)
    disp, xt = (moe._windowed(t[0], o - a, n, g)
                for t in (disp, x[o:o + T][None]))
    xd = torch.einsum("GgEC,Ggd->GECd", disp, xt)
    return xd.movedim(1, 0).reshape(E, -1, x.shape[-1])


@pytest.mark.parametrize("E,K,cap", [(8, 2, 1.25), (8, 2, 0.5), (6, 1, 2.0)])
def test_unequal_windows_fold_onto_the_one_rank_slots(E, K, cap):
    """Four row groups of 48 tokens in groups of 64: each rank's window
    (64, 128, 128, 64 tokens) dispatched as ``moe_apply_tp`` does, padded
    and gathered in rank order, folds onto the one-rank block bit for
    bit, every capacity slot once."""
    n_rows, T, g, d = 4, 48, 64, 16
    gen = torch.Generator().manual_seed(E * 10 + K)
    x = torch.randn((n_rows * T, d), generator=gen)
    logits = torch.randn((n_rows * T, E), generator=gen)
    _, top_p, top_e = moe._route(logits, K)
    C = max(4, -(-int(np.ceil(g * K * cap / E)) // 4) * 4)
    want = _dispatched(x, top_p, top_e, E, C, g)
    part = types.SimpleNamespace(n_rows=n_rows)
    held = partition.HeldJunction(part, {}, {}, ("wg", "wi"), False, ())
    wins, total = held.windowed(T, g, C).fold
    assert [n for _, n in wins] == [C, 2 * C, 2 * C, C] and total == 3 * C
    L = max(n for _, n in wins)
    blocks = []
    for q in range(n_rows):
        b = _dispatched(x, top_p, top_e, E, C, g, q * T, T)
        assert b.shape[1] == wins[q][1]
        blocks.append(torch.cat([b, b.new_zeros((E, L - b.shape[1], d))],
                                1))
    got = partition.fold_windows(torch.cat(blocks, 1), wins, L, total)
    assert torch.equal(got, want)
    assert (want != 0).any(-1).sum() > 0
