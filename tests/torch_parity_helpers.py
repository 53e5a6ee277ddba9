"""What the family parity tests share (test_torch_archs.py,
test_torch_vlm.py, test_torch_mla.py): a port tree held against a
reference tree carried into the port's layout, and the slack of Adam's
first step where a gradient sits at the summation-order noise floor, and
the dry run's variants on a reference config."""
import dataclasses

import numpy as np
import torch

from repro_torch.tree import tree_items


def close_trees(got, want, slack=None, **tol):
    """A port tree against a reference tree carried into the port's
    layout: the same leaves, floats within ``tol``, integers equal.
    ``slack`` ({path: per-element bound}) widens the comparison of the
    elements it names, for at most one element in 10^4 of a leaf."""
    g, w = dict(tree_items(got)), dict(tree_items(want))
    assert g.keys() == w.keys()
    slack = slack or {}
    for k, t in g.items():
        if not torch.is_tensor(t):
            continue
        if not t.is_floating_point():
            assert torch.equal(t, w[k]), k
            continue
        a, b = t.float().numpy(), w[k].float().numpy()
        bound = tol["atol"] + tol["rtol"] * np.abs(b)
        if k in slack:
            wide = np.abs(a - b) > bound
            assert wide.sum() <= max(1, a.size // 10 ** 4), k
            bound = bound + slack[k]
        if not (np.abs(a - b) <= bound).all():
            np.testing.assert_allclose(a, b, err_msg=k, **tol)


def noise_slack(tm, jm, lr, b1=0.9):
    """Adam's first step moves a weight by lr * g / (|g| + eps): where g
    sits at the summation-order noise floor (below 1e-5 of its leaf's
    largest, or of opposite signs on the two sides) that is anything in
    [-lr, lr] on either side, so such an element may differ by 2 lr
    (tests/test_torch_moe.py's rule).  g = m / (1 - b1) after one step."""
    out = {}
    want = dict(tree_items(jm))
    for k, t in tree_items(tm):
        if not (torch.is_tensor(t) and t.is_floating_point() and t.dim()):
            continue
        g, gr = t.numpy() / (1 - b1), want[k].numpy() / (1 - b1)
        floor = ((np.sign(g) != np.sign(gr))
                 | (np.abs(gr) <= 1e-5 * np.abs(gr).max()))
        out[k] = 2 * lr * (1 + 1e-5) * floor
    return out


def reference_variant(jcfg, tcfg):
    """The reference config ``jcfg`` under the variant that the port's
    ``launch/dryrun._apply_variant`` gave ``tcfg``: its sparsity and its
    perf fields carried over (tests/test_torch_dryrun.py holds the port's
    variants equal to the reference's own ``_apply_variant``)."""
    from repro.core.sparsity import SparsityConfig as JSparsity
    sp = tcfg.sparsity
    return dataclasses.replace(
        jcfg, sparsity=None if sp is None else JSparsity(
            density=sp.density, block=sp.block, where=sp.where),
        param_dtype=tcfg.param_dtype, loss_chunk=tcfg.loss_chunk,
        ssm_scan_dtype=tcfg.ssm_scan_dtype)
