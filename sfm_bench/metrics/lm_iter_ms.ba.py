"""Per-layer metric `lm_iter_ms.ba`: milliseconds of one LM iteration of
stage 6's solves (estimators/bundle_adjustment.py _solve_ba, ops/linear.py
cg_generic, the kernels): the seconds of the "ba/lm" spans below the
"bundle adjustment" stage over the `lm_iters` they count. The span ends
with the loop's last host read, so it holds the loop's device work.
"""

from sfm_bench import spans

LAYER = "BA"
UNIT = "ms"
MOVES = "recon_s"


def read(trace):
    """1000 x the "ba/lm" spans' seconds over their LM iterations, or
    None where the program records no spans or no iteration ran."""
    records = spans.window(trace)
    lm = [r for _, rs in spans.by_stage(records or [], "bundle adjustment")
          for r in rs if r.name == "ba/lm"]
    iters = sum(r.counts.get("lm_iters", 0) for r in lm)
    if not iters:
        return None
    return 1000 * sum(spans.seconds(r) for r in lm) / iters
