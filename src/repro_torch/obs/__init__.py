"""Flight-recorder telemetry.  See obs/telemetry.py."""
from repro_torch.obs.telemetry import (  # noqa: F401
    Checkpoint,
    Guardian,
    Histogram,
    NOT_SAMPLED,
    Recorder,
    RequestSpan,
    SweepRound,
    TrainStep,
    percentile,
    profile_ctx,
    read_events,
)

__all__ = [
    "Checkpoint", "Guardian", "Histogram", "NOT_SAMPLED", "Recorder",
    "RequestSpan", "SweepRound", "TrainStep", "percentile", "profile_ctx",
    "read_events",
]
