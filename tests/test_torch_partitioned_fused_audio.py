"""The audio family's fused BP+UP train step on the partitioned mesh
route on the "sp" strategy (``steps.make_mesh_train_step``: every
whisper weight whole over "model" and FSDP over the dp axes, each fused
junction's update over every row of the batch, ``partition.HeldJunction``:
where the unit's rows, the decoder's positions or the encoder's frames,
are split over "model", its operands are gathered over the row axes and
"model"; where every model rank holds them all, dy, partial on each, is
all-reduced over "model" first and the operands gathered over the row
axes) against one rank, the JAX reference and the dry run's reckoning,
on the CPU.

* 8 gloo ranks on a 2 x 4 (data x model) mesh run ``FUSED_AUDIO_CASES``
  (tests/torch_mesh_workers.py), fp32, FFN density 0.5 at block 32, 4
  rows a step: reduced whisper-base (2 encoder and 2 decoder layers) on
  64 positions and 16 frames (both split, 16 positions and 4 frames a
  model rank), on 66 positions (whole on every rank, the frames split),
  and on 64 positions with 18 frames, which "model" does not divide (the
  frames whole on every rank, as the production model's 1500 frames on
  a 16-wide axis).  Each takes 3 steps of clipped fused Adam (lr 1e-3,
  clip 1.0) and / or fused SGD with momentum (lr 3e-2, 0.9), on weights
  and batches the reference made, carried through numpy:
  - the losses, the gathered params and slots against the port's
    one-rank fused step and the reference's single-device fused step
    (engine "pallas", its kernels in interpret mode): losses to 1e-5,
    params and slots to rtol 5e-4 / atol 5e-5 (``noise_slack`` summed
    over the steps);
  - ``nonfinite`` equals the one-rank step's count, 0 here;
  - every rank holds at rest only its shards, after each step; it
    gathers one unit at a time, a fused junction's weight and slots
    included, and no gathered junction outlives its backward;
  - the collectives, dot FLOPs and held bytes of every rank's first step
    equal ``launch/dryrun.count_cell``'s reckoning on
    ``AbstractMesh((2, 4))``.
* Each case's rows: whether the decoder's positions and the encoder's
  frames split over "model" (``Partition.seq_split``), so that each of
  the two row layouts of a fused junction's update is exercised.
"""
import pytest
import torch

from repro.configs import registry as jreg

from repro_torch.launch.mesh import AbstractMesh
from repro_torch.parallel import partition
from repro_torch.train import steps
from torch_fused_mesh_checks import MESH, check_at_rest, \
    check_collectives, check_gathers, check_nonfinite, check_parity, \
    one_rank, rank_out, reference_cfg, write_inputs
from torch_mesh_workers import FUSED_AUDIO_CASES, PART_B, \
    fused_audio_case, fused_audio_run, fused_mesh_opt, join_ranks, \
    start_ranks

RUNS = [(i, kind) for i, case in enumerate(FUSED_AUDIO_CASES)
        for kind in case[2]]
IDS = [f"S{FUSED_AUDIO_CASES[i][0]}-{i}-{kind}" for i, kind in RUNS]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(case):
    _, changes, _ = case
    tcfg = fused_audio_case(changes)
    return reference_cfg(jreg.get("whisper-base").reduced(), tcfg,
                         **changes), tcfg


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The reference's weights and batches of each case (``in_<i>.npz``),
    and the 8 ranks started on them."""
    d = tmp_path_factory.mktemp("partitioned_fused_audio")
    for i, case in enumerate(FUSED_AUDIO_CASES):
        write_inputs(d / f"in_{i}.npz", _cfgs(case)[0], PART_B, case[0])
    return d, start_ranks(fused_audio_run, 8, str(d))


@pytest.fixture(scope="module")
def one_ranks(inputs):
    """Per run: the port's one-rank and the reference's fused steps
    (``torch_fused_mesh_checks.one_rank``), made while the ranks run."""
    d, _ = inputs
    return {(i, kind): one_rank(d / f"in_{i}.npz", *_cfgs(
        FUSED_AUDIO_CASES[i]), kind) for i, kind in RUNS}


@pytest.fixture(scope="module")
def runs(inputs, one_ranks):
    """The directory of the 8 ranks' results, once they have ended."""
    d, ctx = inputs
    join_ranks(ctx)
    return d


# ------------------------------------------------------------ the cases
@pytest.mark.parametrize("i,split", [(0, (True, True)), (1, (False, True)),
                                     (2, (True, False))])
def test_case_rows_split_over_model_or_not(i, split):
    """(positions split, frames split) of each case on the 4-wide
    "model" axis."""
    S, changes, kinds = FUSED_AUDIO_CASES[i]
    cfg = fused_audio_case(changes)
    part = partition.Partition(cfg, partition.ReckonedComm(AbstractMesh(
        MESH, ("data", "model"))), {})
    assert (part.seq_split(S), part.seq_split(cfg.enc_frames)) == split
    for kind in kinds:
        opt = fused_mesh_opt(kind)
        assert steps.fused_update_eligible(cfg, opt)[0]
        assert cfg.strategy == "sp" and steps.partitioned(cfg, opt)


# ------------------------------------------------------------ 8 ranks
@pytest.mark.parametrize("i,kind", RUNS, ids=IDS)
def test_fused_steps_match_one_rank_and_reference(i, kind, runs, one_ranks):
    out, _ = rank_out(runs, i, kind)
    port, ref, slack = one_ranks[(i, kind)]
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
    check_gathers(rank_out(runs, i, kind)[1], junction_gathers=True)


@pytest.mark.parametrize("i,kind", RUNS, ids=IDS)
def test_collectives_equal_reckoning(i, kind, runs):
    S, changes, _ = FUSED_AUDIO_CASES[i]
    check_collectives(rank_out(runs, i, kind)[1], fused_audio_case(changes),
                      PART_B, S, kind)
