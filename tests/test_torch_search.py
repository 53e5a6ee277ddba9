"""The port's population search against the JAX reference on the CPU:
the hyp table and slot conventions, the population step's per-member
health on the fused and two-pass paths, the successive-halving scheduler
(``run_sweep``) on weights carried across from the reference, the
reference's own sweep and quarantine contracts rerun on the port, and the
``launch.sweep`` launcher with its ``--obs`` events.

Shapes are the reference tests' own: layers (256, 128, 32) or one
junction (N_IN, N_OUT) = (128, 64), block 32, density 0.5; inputs made
with numpy.  The reference runs its Pallas kernels in interpret mode on
the fused path and its jnp engine on the two-pass path.

Tolerances: losses and eval losses within rtol 1e-5 / atol 1e-6 (fp32
sums in another order); the health counts, the prune / quarantine /
winner decisions and the survivors of a quarantine exact.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SweepConfig as JSweepConfig
from repro.data.mnist import paper_dataset
from repro.search import cohorts as jcoh
from repro.search import population as jpop
from repro.search import scheduler as jsched

from repro_torch import convert
from repro_torch.configs.base import SweepConfig
from repro_torch.launch import obs_report
from repro_torch.launch import sweep as tsweep
from repro_torch.obs import read_events
from repro_torch.search import Ledger
from repro_torch.search import population as tpop
from repro_torch.search import scheduler as tsched

N_IN, N_OUT, BATCH = 128, 64, 32
LAYERS = (256, 128, 32)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(mod, lrs, momentum=0.0, layers=LAYERS, density=0.5, opt="sgd"):
    return [mod.CandidateSpec(lr=lr, momentum=momentum, density=density,
                              layers=layers, block=32, init_seed=i, opt=opt)
            for i, lr in enumerate(lrs)]


def _carry(jparams):
    return convert.from_jax_population(jax.tree.map(np.asarray, jparams))


def _batch(m, n_in, n_out, seed=0):
    """A synthetic-MNIST batch sliced to n_in, one-hot padded to n_out."""
    x, t, _ = paper_dataset(n=m, seed=seed)
    tp = np.zeros((m, n_out), np.float32)
    tp[:, :t.shape[1]] = t[:, :n_out]
    return x[:, :n_in], tp


def _gaussian_data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, N_IN)).astype(np.float32)
    t = np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, n)]
    return x, t


# ------------------------------------------------------------ conventions
@pytest.mark.parametrize("opt,momentum", [("sgd", 0.0), ("sgd", 0.9),
                                          ("adam", 0.9)])
def test_hyp_table_and_slots_match_reference(opt, momentum):
    jspecs = _specs(jpop, (0.05, 0.2), momentum, opt=opt)
    tspecs = _specs(tpop, (0.05, 0.2), momentum, opt=opt)
    np.testing.assert_array_equal(tpop.hyp_table(tspecs, "cpu").numpy(),
                                  np.asarray(jpop.hyp_table(jspecs)))
    jp = jpop.init_population(jax.random.PRNGKey(0), jspecs)
    tp = tpop.init_population(0, tspecs, "cpu")
    js, ts = jpop.init_slots(jp, jspecs), tpop.init_slots(tp, tspecs)
    assert type(ts) is tuple and len(ts) == len(js)
    for jtree, ttree in zip(js, ts):
        for jl, tl in zip(jtree, ttree):
            for k in ("w", "b"):
                assert tl[k].dtype == torch.float32
                assert tuple(tl[k].shape) == jl[k].shape
                assert not tl[k].any()
    jm, tm = jpop.init_momentum(jp, jspecs), tpop.init_momentum(tp, tspecs)
    assert (jm is None) == (tm is None)
    # no specs: always a momentum tree, as the reference
    assert tpop.init_momentum(tp) is not None
    assert jpop.init_momentum(jp) is not None


@pytest.mark.parametrize("like", [None, "tree", "tuple"])
def test_repack_slots_conventions(like):
    new = ("m", "v")
    arg = {"tree": ["mom"], "tuple": ("m", "v"), None: None}[like]
    assert tpop._repack_slots(new, arg) == jpop._repack_slots(new, arg)
    assert tpop._repack_slots(new, arg) == {"tree": "m", "tuple": new,
                                            None: None}[like]


# ---------------------------------------------------------------- health
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two_pass"])
def test_population_health_matches_reference(fused):
    """Clean update: health [0, 0, 0]; a NaN in member 1's first weight:
    the reference's counts (its kernels' tiles on the fused path, its
    non-finite gradient leaves on the two-pass path), member 1 alone."""
    jspecs = _specs(jpop, (0.05, 0.1, 0.2), layers=(N_IN, N_OUT))
    tspecs = _specs(tpop, (0.05, 0.1, 0.2), layers=(N_IN, N_OUT))
    jp = jpop.init_population(jax.random.PRNGKey(0), jspecs)
    x, t = _gaussian_data(BATCH, 1)
    mask = np.ones((3,), np.float32)
    jstep = jpop.make_population_step(
        "sigmoid", engine="pallas" if fused else "jnp", fused=fused,
        jit=False, with_health=True)
    tstep = tpop.make_population_step("sigmoid", fused=fused,
                                      with_health=True)

    def both(jparams):
        tparams = _carry(jparams)
        _, _, jl, jh = jstep(jparams, None, jpop.hyp_table(jspecs), mask,
                             x, t)
        tp, _, tl, th = tstep(tparams, None, tpop.hyp_table(tspecs, "cpu"),
                              torch.from_numpy(mask), torch.from_numpy(x),
                              torch.from_numpy(t))
        return np.asarray(jh), th.numpy(), np.asarray(jl), tl.numpy(), tp

    jh, th, jl, tl, _ = both(jp)
    assert th.tolist() == jh.tolist() == [0.0, 0.0, 0.0]
    np.testing.assert_allclose(tl, jl, **TOL)
    jp[0]["w"] = jp[0]["w"].at[1, 0, 0, 0, 0].set(jnp.nan)
    jh, th, jl, tl, tp = both(jp)
    assert th.dtype == np.float32
    assert th.tolist() == jh.tolist()
    assert th[1] > 0 and th[0] == 0 and th[2] == 0
    for e in (0, 2):
        for layer in tpop.member_slice(tp, e):
            assert bool(torch.isfinite(layer["w"]).all())


def test_population_step_returns_slots_in_the_callers_form():
    """None in, None out; one tree in, the same tree out (updated in
    place); a tuple in, a tuple out."""
    tspecs = _specs(tpop, (0.05, 0.1), 0.9, layers=(N_IN, N_OUT))
    x, t = (torch.from_numpy(a) for a in _gaussian_data(BATCH, 2))
    step = tpop.make_population_step("sigmoid")
    hyp = tpop.hyp_table(tspecs, "cpu")
    mask = torch.ones(2)

    def fresh():        # the step updates its params in place
        return tpop.init_population(0, tspecs, "cpu")

    assert step(fresh(), None, hyp, mask, x, t)[1] is None
    p = fresh()
    mom = tpop.init_momentum(p, tspecs)
    assert step(p, mom, hyp, mask, x, t)[1] is mom
    assert mom[0]["w"].abs().sum() > 0
    p = fresh()
    slots = tpop.init_slots(p, tspecs)
    assert step(p, slots, hyp, mask, x, t)[1] is slots


# -------------------------------------------------- run_sweep, carried
def _sweep_case(case):
    """(candidate lrs x densities, SweepConfig kwargs) of a parity case:
    a plain grid, and one with an lr=inf member that is quarantined."""
    grid = [(0.5, 0.05), (0.5, 0.3), (0.25, 0.1), (0.25, 0.6)]
    if case == "quarantine":
        grid.append((0.5, float("inf")))
    return grid, dict(rounds=3, steps_per_round=2, batch_size=32,
                      eval_samples=32, keep_fraction=0.5)


@pytest.mark.parametrize("case", ["grid", "quarantine"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two_pass"])
def test_run_sweep_matches_reference_on_carried_weights(case, fused,
                                                        monkeypatch):
    grid, kw = _sweep_case(case)
    layers = (N_IN, N_OUT)

    def specs(mod):
        return [mod.CandidateSpec(lr=lr, density=d, layers=layers, block=32,
                                  init_seed=i)
                for i, (d, lr) in enumerate(grid)]

    jspecs, tspecs = specs(jpop), specs(tpop)
    engine = "pallas" if fused else "jnp"
    jcfg = JSweepConfig(**kw, engine=engine)
    tcfg = SweepConfig(**kw, engine=engine)
    x, t, _ = paper_dataset(n=160, seed=3)
    x = x[:, :N_IN]
    args = (x[:128], t[:128], x[128:], t[128:])
    jres = jsched.run_sweep(jspecs, *args, jcfg)

    # the port's cohorts start from the reference's initial weights
    key = jax.random.PRNGKey(jcfg.seed)
    cohort_of = {c.specs: ci for ci, c in enumerate(jcoh.bucket(jspecs))}

    def carried(seed, cohort_specs, device=None):
        ci = cohort_of[tuple(jpop.CandidateSpec(**s.to_dict() | {
            "layers": tuple(s.layers)}) for s in cohort_specs)]
        return _carry(jpop.init_population(jax.random.fold_in(key, ci),
                                           jcoh.bucket(jspecs)[ci].specs))

    monkeypatch.setattr(tsched.pop, "init_population", carried)
    tres = tsched.run_sweep(tspecs, *args, tcfg, device="cpu")

    jm, tm = jres.ledger.members, tres.ledger.members
    assert len(tm) == len(jm)
    for a, b in zip(tm, jm):
        assert (a.member, a.cohort, a.slot) == (b.member, b.cohort, b.slot)
        np.testing.assert_allclose(a.loss_curve, b.loss_curve, **TOL)
        np.testing.assert_allclose(a.eval_losses, b.eval_losses, **TOL)
        assert (a.pruned_at, a.quarantined_at, a.rounds_survived,
                a.winner) == (b.pruned_at, b.quarantined_at,
                              b.rounds_survived, b.winner)
    assert tres.ledger.meta["quarantined"] == jres.ledger.meta["quarantined"]
    assert tres.ledger.meta["quarantined"] == (case == "quarantine")
    # the decisions mean something: adjacent finite scores of every round
    # lie more than 100x the tolerance apart
    for r in range(jcfg.rounds):
        s = sorted(jsched._score(m.eval_losses[r], N_OUT) for m in jm
                   if len(m.eval_losses) > r)
        s = [v for v in s if math.isfinite(v)]
        for lo, hi in zip(s, s[1:]):
            # a score is loss * N_OUT: its tolerance scales alike
            assert hi - lo > 100 * (TOL["rtol"] * abs(lo)
                                    + TOL["atol"] * N_OUT), (r, s)


# ------------------------------------------- the reference's contracts
@pytest.mark.parametrize("fused", [False, True], ids=["two_pass", "fused"])
def test_pruned_slot_frozen_in_place(fused):
    """Zero mask entry + zero hyp row freezes that member's w and b
    exactly (its momentum goes to zero: b1 = 0, gradient 0) while the
    others keep training."""
    specs = _specs(tpop, (0.02, 0.05, 0.08, 0.12), 0.9)
    E = len(specs)
    params = tpop.init_population(3, specs, "cpu")
    x, t = (torch.from_numpy(a) for a in _batch(32, LAYERS[0], LAYERS[-1]))
    step = tpop.make_population_step(fused=fused)
    hyp = tpop.hyp_table(specs, "cpu")
    mom = tpop.init_momentum(params)
    # one live step so momentum is nonzero when the prune lands
    step(params, mom, hyp, torch.ones(E), x, t)
    p1 = [{k: v.clone() for k, v in layer.items()} for layer in params]
    pruned = 1
    mask = torch.ones(E)
    mask[pruned] = 0.0
    hyp[pruned] = 0.0
    _, _, losses = step(params, mom, hyp, mask, x, t)
    assert tuple(losses.shape) == (E,)
    for li in range(len(params)):
        for k in ("w", "b"):
            assert torch.equal(params[li][k][pruned], p1[li][k][pruned])
            assert not mom[li][k][pruned].any()
        for e in range(E):
            if e != pruned:
                assert not torch.equal(params[li]["w"][e], p1[li]["w"][e])


def test_run_sweep_end_to_end(tmp_path):
    """A density x lr sweep names a winning config; halving prunes across
    cohorts; the JSON ledger round-trips with its meta stamp."""
    specs = [tpop.CandidateSpec(lr=lr, density=d, layers=LAYERS, block=32,
                                init_seed=i)
             for i, (d, lr) in enumerate((d, lr) for d in (0.25, 0.5)
                                         for lr in (0.05, 0.2))]
    x, t, _ = paper_dataset(n=160, seed=0)
    x = x[:, :256]
    cfg = SweepConfig(rounds=2, steps_per_round=2, batch_size=32,
                      eval_samples=32, engine="jnp")
    result = tsched.run_sweep(specs, x[:128], t[:128], x[128:], t[128:],
                              cfg, tag="test", device="cpu")
    led = result.ledger
    assert len(led.members) == 4
    w = led.winner()
    assert w is not None and w.config["lr"] in (0.05, 0.2)
    assert w.pruned_at is None and w.rounds_survived == 2
    pruned = [m for m in led.members if m.pruned_at is not None]
    assert len(pruned) == 2 and all(m.pruned_at == 0 for m in pruned)
    assert all(m.rounds_survived == 1 for m in pruned)
    live = [m for m in led.members if m.pruned_at is None]
    assert all(len(m.loss_curve) == 4 for m in live)
    assert all(len(m.loss_curve) == 2 for m in pruned)
    wp = result.winning_params()
    assert wp is not None and wp[0]["w"].dim() == 4

    path = tmp_path / "SWEEP_test.json"
    led.save(str(path))
    led2 = Ledger.load(str(path))
    assert led2.meta["tag"] == "test"
    assert led2.meta["git_sha"]
    assert led2.winner().member == w.member
    assert led2.winner().config == w.config
    assert [m.to_dict() for m in led2.members] == [
        json.loads(json.dumps(m.to_dict())) for m in led.members]
    raw = json.loads(path.read_text())
    assert raw["winner"]["member"] == w.member
    # the reference's keys, at the top and in every record
    jled = jsched.Ledger(meta={}, members=[jsched.MemberRecord(
        member=0, config={}, cohort=0, slot=0)])
    assert set(raw) == set(jled.to_dict())
    assert set(raw["members"][0]) == set(jled.members[0].to_dict())
    assert {"engine", "rounds", "steps_per_round", "n_candidates",
            "live_at_end", "quarantined", "tag", "git_sha"} <= set(
        raw["meta"])


def test_run_sweep_adam_lr_x_b1_fused():
    """A fused Adam lr x b1 sweep (per-member Adam rows, COL_T stamped a
    step, quarantine on the update health) names an Adam winner."""
    specs = [tpop.CandidateSpec(lr=lr, momentum=b1, opt="adam", density=0.5,
                                layers=LAYERS, block=32, init_seed=i)
             for i, (lr, b1) in enumerate((lr, b1) for lr in (1e-3, 5e-3)
                                          for b1 in (0.8, 0.9))]
    x, t, _ = paper_dataset(n=160, seed=0)
    x = x[:, :256]
    cfg = SweepConfig(rounds=2, steps_per_round=2, batch_size=32,
                      eval_samples=32, engine="pallas")
    result = tsched.run_sweep(specs, x[:128], t[:128], x[128:], t[128:],
                              cfg, tag="adam-smoke", device="cpu")
    led = result.ledger
    assert len(led.members) == 4
    w = led.winner()
    assert w is not None and w.config["opt"] == "adam"
    assert w.config["momentum"] in (0.8, 0.9)
    assert result.winning_params()[0]["w"].dim() == 4
    # every live row carries the last step's time
    st = result.states[0]
    assert st.hyp[0, tsched.bsm.COL_T].item() == 4.0


@pytest.mark.parametrize("engine", ["jnp", "pallas"])
def test_quarantine_leaves_survivors_bitwise_identical(engine):
    """A cohort with an lr=inf member, quarantined in the middle of a
    round, leaves its survivors bitwise equal to a cohort without it, and
    names a finite winner."""
    x, t = _gaussian_data(256, 0)
    xe, te = _gaussian_data(64, 1)

    def spec(lr, i):
        return tpop.CandidateSpec(lr=lr, density=0.5, layers=(N_IN, N_OUT),
                                  block=32, init_seed=i)

    good = [spec(0.05, 0), spec(0.1, 1)]
    bad = spec(float("inf"), 2)
    cfg = SweepConfig(rounds=2, steps_per_round=4, batch_size=32,
                      eval_samples=64, keep_fraction=1.0, engine=engine,
                      fused=(engine == "pallas"))
    r_with = tsched.run_sweep(good + [bad], x, t, xe, te, cfg, device="cpu")
    r_without = tsched.run_sweep(good, x, t, xe, te, cfg, device="cpu")

    qrec = r_with.ledger.members[2]
    # step 0's update is the one that goes non-finite; the health reads
    # the gradient, which turns non-finite at step 1
    assert qrec.quarantined_at == {"round": 0, "step": 1}
    assert qrec.pruned_at == qrec.quarantined_at["round"]
    assert r_with.ledger.meta["quarantined"] == 1
    for m in r_with.ledger.members[:2]:
        assert m.quarantined_at is None and m.pruned_at is None
    for e in range(2):
        for lw, lo in zip(tpop.member_slice(r_with.states[0].params, e),
                          tpop.member_slice(r_without.states[0].params, e)):
            for k in ("w", "b"):
                assert lw[k].numpy().tobytes() == lo[k].numpy().tobytes()
    w1, w2 = r_with.ledger.winner(), r_without.ledger.winner()
    assert w1 is not None and w1.member == w2.member
    assert np.isfinite(w1.eval_losses[-1])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two_pass"])
def test_population_health_isolates_bad_member(fused):
    """One member with a poisoned weight flags only its own slot, and the
    clean members' updates stay finite."""
    specs = _specs(tpop, (0.05, 0.05, 0.05), layers=(N_IN, N_OUT))
    params = tpop.init_population(0, specs, "cpu")
    mom = tpop.init_momentum(params, specs)
    hyp = tpop.hyp_table(specs, "cpu")
    mask = torch.ones(3)
    x, t = (torch.from_numpy(a) for a in _gaussian_data(BATCH, 1))
    step = tpop.make_population_step(fused=fused, with_health=True)
    clean = [{k: v.clone() for k, v in layer.items()} for layer in params]
    _, _, _, health = step(clean, mom, hyp, mask, x, t)
    assert health.tolist() == [0.0, 0.0, 0.0]
    params[0]["w"][1, 0, 0, 0, 0] = float("nan")
    new_params, _, _, health = step(params, mom, hyp, mask, x, t)
    assert health[1] > 0 and health[0] == 0 and health[2] == 0
    for e in (0, 2):
        for layer in tpop.member_slice(new_params, e):
            assert bool(torch.isfinite(layer["w"]).all())


def test_rank_score_nan_and_width_policy():
    """A non-finite eval loss scores +inf; scores are width-normalized
    (the per-sample total squared error), as the reference's."""
    for loss, width in ((float("nan"), 32), (float("inf"), 32),
                        (0.01, 128), (0.04, 32), (0.02, 32)):
        assert tsched._score(loss, width) == jsched._score(loss, width)
    assert tsched._score(float("nan"), 32) == math.inf
    assert tsched._score(0.01, 128) == pytest.approx(tsched._score(0.04, 32))
    assert tsched._score(0.02, 32) < tsched._score(0.01, 128)


def test_pad_targets_and_batch_indices_match_reference():
    t = np.eye(10, dtype=np.float32)[[1, 4, 9]]
    np.testing.assert_array_equal(tsched._pad_targets(t, 32),
                                  jsched._pad_targets(t, 32))
    with pytest.raises(ValueError, match="wider"):
        tsched._pad_targets(t, 8)
    for step in (0, 3, 7):
        np.testing.assert_array_equal(
            tsched._batch_indices(100, 32, step).numpy(),
            jsched._batch_indices(100, 32, step))


def test_sweep_single_candidate_wins():
    specs = _specs(tpop, (0.02,))
    x, t, _ = paper_dataset(n=96, seed=1)
    x = x[:, :256]
    cfg = SweepConfig(rounds=2, steps_per_round=1, batch_size=32,
                      eval_samples=32, engine="jnp")
    result = tsched.run_sweep(specs, x[:64], t[:64], x[64:], t[64:], cfg,
                              device="cpu")
    w = result.ledger.winner()
    assert w is not None and w.member == 0 and w.rounds_survived == 2


# -------------------------------------------------------------- launcher
def test_sweep_launcher_on_cpu_with_obs(tmp_path, capsys):
    out, sink = tmp_path / "SWEEP.json", tmp_path / "sweep.jsonl"
    result = tsweep.main([
        "--device", "cpu", "--densities", "0.25,0.5", "--lrs", "0.05,inf",
        "--rounds", "2", "--steps-per-round", "2", "--batch", "16",
        "--samples", "64", "--eval-samples", "32", "--block", "32",
        "--hidden", "128", "--out", str(out), "--obs", str(sink)])
    text = capsys.readouterr().out
    assert "[sweep] 4 candidates in 2 cohort(s)" in text
    assert "update path: fused BP+UP" in text
    assert "[sweep] winner: density=" in text
    assert text.count("quarantined@r0") == 2
    led = Ledger.load(str(out))
    assert led.winner().member == result.ledger.winner().member
    assert led.meta["quarantined"] == 2
    _, events = read_events(str(sink))
    rounds = [e for e in events if e["kind"] == "sweep.round"]
    actions = [e["action"] for e in rounds]
    assert actions.count("quarantine") == 2
    assert actions.count("rank") == 2 and actions.count("winner") == 1
    assert actions.count("prune") == 1     # 2 live after round 0: keep 1
    report = obs_report.build_report(events)
    table = report["sweep"]
    assert [r["action"] for r in table].count("rank") == 2
    assert any(r.get("member") == led.winner().member
               and r["action"] == "winner" for r in table)


def test_sweep_launcher_adam_grid_and_two_pass(tmp_path, capsys):
    tsweep.main(["--device", "cpu", "--optim", "adam", "--densities", "0.5",
                 "--lrs", "0.001,0.005", "--b1s", "0.8,0.9", "--rounds", "2",
                 "--steps-per-round", "1", "--batch", "16", "--samples",
                 "64", "--eval-samples", "32", "--block", "32", "--hidden",
                 "128", "--engine", "jnp", "--out", str(tmp_path / "a.json")])
    text = capsys.readouterr().out
    assert "[sweep] 4 candidates in 1 cohort(s)" in text
    assert "optim=adam update path: two-pass (materialized grads)" in text
    assert " b1=" in text and "WINNER" in text
