"""Population search: many candidate networks trained on the junction
kernels' E axis at once.

A population is E candidate MLPs of one structure stacked into the
kernels' unit dimension (``population``); ``cohorts`` buckets a
candidate list by that structure, ``scheduler.run_sweep`` trains the
cohorts by successive halving with in-place pruning and quarantine, and
``ledger`` writes each member's lineage as JSON.  ``launch/sweep.py`` is
the command line, ``configs.base.SweepConfig`` its settings.
"""
from repro_torch.search.cohorts import (Cohort, QuantCohort, bucket,
                                        bucket_quant)
from repro_torch.search.ledger import Ledger, MemberRecord
from repro_torch.search.population import (CandidateSpec, hyp_table,
                                           init_population, init_slots,
                                           make_population_eval,
                                           make_population_step,
                                           member_slice, structure_key)
from repro_torch.search.scheduler import SweepResult, run_sweep

__all__ = ["CandidateSpec", "Cohort", "Ledger", "MemberRecord",
           "QuantCohort", "SweepResult", "bucket", "bucket_quant",
           "hyp_table", "init_population", "init_slots",
           "make_population_eval", "make_population_step",
           "member_slice", "run_sweep", "structure_key"]
