"""Per-layer metric `hyp_per_s.frontend`: the RANSAC's throughput in
stage 2 (estimators/relpose.py, the batched LO-RANSAC over every pair):
the pair-hypotheses the "frontend/ransac" spans count (`hypotheses`,
summed over the pairs) over those spans' seconds. Each span ends with
the host read of the last chunk's best counts, so it holds the chunks'
device work.
"""

from sfm_bench import spans

LAYER = "front end"
UNIT = "1/s"
MOVES = "recon_s"


def read(trace):
    """Hypotheses a second of the "frontend/ransac" spans, or None where
    the program records no spans, no such span ran, or it counted no
    hypotheses."""
    records = spans.window(trace)
    ransac = [r for r in records or () if r.name == "frontend/ransac"]
    hypotheses = sum(r.counts.get("hypotheses", 0) for r in ransac)
    seconds = sum(spans.seconds(r) for r in ransac)
    if not hypotheses or seconds <= 0:
        return None
    return hypotheses / seconds
