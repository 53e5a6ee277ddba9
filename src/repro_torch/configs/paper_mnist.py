"""The paper's own configuration (Table I): 1024-64-32 pre-defined-sparse
MLP, (12,3,8) fixed point, z=(128,32), trained on (synthetic) MNIST.

    from repro_torch.configs.paper_mnist import CONFIG, FC_BASELINE
"""
from repro_torch.core import fixed_point as fxp
from repro_torch.core.paper_net import PaperNetConfig

# Table I exactly: d_out=(4,16) -> densities 6.25 % / 50 %, 7.576 % overall
CONFIG = PaperNetConfig(
    layers=(1024, 64, 32),
    d_out=(4, 16),
    z=(128, 32),
    fmt=fxp.PAPER_FMT,          # (b_w, b_n, b_f) = (12, 3, 8)
    activation="sigmoid",
)

# the fully-connected baseline the paper compares against (Fig. 5)
FC_BASELINE = PaperNetConfig(
    layers=(1024, 64, 32),
    d_out=(64, 32),             # d_out = N_i -> dense
    z=(1024, 64),
    fmt=fxp.PAPER_FMT,
    activation="sigmoid",
)

__all__ = ["CONFIG", "FC_BASELINE"]
