"""Per-layer metric `layer_s.gp`: seconds a reconstruction spends in stage
5 (estimators/global_positioning.py).
"""

LAYER = "GP"
UNIT = "s"
MOVES = "recon_s"
STAGES = ("global positioning",)


def read(trace):
    """Seconds a reconstruction spends in STAGES (StageTimer's host
    clock, each boundary synchronizing the card), or None where none of
    them ran."""
    return trace.stage_s(*STAGES)
