"""The PyTorch port's pattern and config modules against the JAX
reference: the same arguments give identical block patterns (forward and
reverse), the same fan-in rounding and the same architecture configs."""
import dataclasses

import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.core import sparsity as jsp

from repro_torch.configs import registry as treg
from repro_torch.core import sparsity as tsp

PATTERN_CASES = [
    # full-width stablelm-3b FFN junctions (wg/wi, wo)
    (2560, 6912, 0.25, 128, 0), (2560, 6912, 0.25, 128, 2),
    (6912, 2560, 0.25, 128, 1),
    # their block-32 copy (same idx), used by the kernel parity tests
    (640, 1728, 0.25, 32, 0), (1728, 640, 0.25, 32, 1),
    # reduced stablelm-3b FFN junctions
    (128, 256, 0.5, 32, 0), (256, 128, 0.5, 32, 1),
    (128, 256, 0.25, 32, 2), (256, 128, 0.25, 32, 1),
    # exactly balanced (circulant branch) and the paper bench junction
    (1024, 512, 0.25, 128, 0), (512, 512, 0.5, 64, 3),
]


@pytest.mark.parametrize("n_in,n_out,density,block,seed", PATTERN_CASES)
def test_block_pattern_identical(n_in, n_out, density, block, seed):
    j = jsp.make_block_pattern(n_in, n_out, density, block, seed=seed)
    t = tsp.make_block_pattern(n_in, n_out, density, block, seed=seed)
    for name in ("idx", "rev_ob", "rev_t", "rev_cnt"):
        a, b = getattr(j, name), getattr(t, name)
        assert a.dtype == b.dtype == np.int32, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert (t.n_in_blocks, t.n_out_blocks, t.fan_in_blocks, t.fan_out_blocks) \
        == (j.n_in_blocks, j.n_out_blocks, j.fan_in_blocks, j.fan_out_blocks)


def test_full_width_stablelm_pattern_shapes():
    up = tsp.make_block_pattern(2560, 6912, 0.25, 128, seed=0)
    down = tsp.make_block_pattern(6912, 2560, 0.25, 128, seed=1)
    assert up.idx.shape == (54, 5)
    assert set(np.unique(up.rev_cnt)) == {13, 14}       # ragged reverse
    assert down.idx.shape == (20, 14)                   # round(13.5) == 14
    for pat in (up, down):
        assert all(len(set(row)) == len(row) for row in pat.idx.tolist())


@pytest.mark.parametrize("nib,density", [
    (54, 0.25), (50, 0.25), (20, 0.25), (4, 0.5), (8, 0.125), (3, 0.01),
    (7, 1.0), (10, 0.35), (22, 0.25)])
def test_block_fan_in_rounding(nib, density):
    assert tsp.block_fan_in(nib, density) == jsp.block_fan_in(nib, density)


def test_sparsity_config_applies_to():
    for where in ("ffn", "attn", "all", "ffn+attn"):
        for density in (0.25, 1.0):
            j = jsp.SparsityConfig(density=density, where=where)
            t = tsp.SparsityConfig(density=density, where=where)
            for fam in ("ffn", "attn", "moe"):
                assert t.applies_to(fam) == j.applies_to(fam)


@pytest.mark.parametrize("name", sorted(jreg.ARCHS))
def test_registry_entries_match_reference(name):
    """Every field the port keeps equals the reference's, at full width
    and reduced."""
    for j, t in ((jreg.get(name), treg.get(name)),
                 (jreg.get(name).reduced(), treg.get(name).reduced())):
        for f in dataclasses.fields(t):
            a, b = getattr(j, f.name), getattr(t, f.name)
            if dataclasses.is_dataclass(a):
                assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
            else:
                assert a == b, (name, f.name)


def test_reduced_keeps_sparsity_and_compute_dtype():
    cfg = treg.get("stablelm-3b").with_sparsity(tsp.SparsityConfig(0.25, 128))
    red = cfg.reduced()
    assert red.sparsity.block == 32 and red.sparsity.density == 0.25
    assert str(red.compute_dtype) == "torch.bfloat16"
    with pytest.raises(KeyError):
        treg.get("no-such-arch")
