"""Per-layer metric `layer_s.ra`: seconds a reconstruction spends in stage
3 (estimators/rotation_averaging.py, controllers/rotation_averager.py).
"""

LAYER = "rotation averaging"
UNIT = "s"
MOVES = "recon_s"
STAGES = ("rotation averaging",)


def read(trace):
    """Seconds a reconstruction spends in STAGES (StageTimer's host
    clock, each boundary synchronizing the card), or None where none of
    them ran."""
    return trace.stage_s(*STAGES)
