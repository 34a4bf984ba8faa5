"""Per-layer metric `host_reads.ba`: blocking host reads a reconstruction
makes in stage 6's solver loops, each one emptying the card's queue: the
LM exit test of _solve_ba (estimators/bundle_adjustment.py) and the CG
exit test on every CG iteration (ops/linear.py cg_generic), as the
program counts them (`host_reads`, utils/profiling.host_bool).
"""

from sfm_bench import spans

LAYER = "BA"
UNIT = "1"
MOVES = "recon_s"


def read(trace):
    """The `host_reads` counted below the "bundle adjustment" stage
    spans, a reconstruction, or None where the program records no spans
    or the stage did not run."""
    records = spans.window(trace)
    stages = spans.by_stage(records or [], "bundle adjustment")
    if not stages:
        return None
    return sum(r.counts.get("host_reads", 0) for s, rs in stages
               for r in (s, *rs)) / trace.recons
