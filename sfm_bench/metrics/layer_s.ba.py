"""Per-layer metric `layer_s.ba`: seconds a reconstruction spends in stage
6 (estimators/bundle_adjustment.py, ops/linear.py).
"""

LAYER = "BA"
UNIT = "s"
MOVES = "recon_s"
STAGES = ("bundle adjustment",)


def read(trace):
    """Seconds a reconstruction spends in STAGES (StageTimer's host
    clock, each boundary synchronizing the card), or None where none of
    them ran."""
    return trace.stage_s(*STAGES)
