"""Per-layer metric `layer_s.host`: seconds a reconstruction spends in the
host passes of stages 4 and 8 (controllers/track_establishment.py,
native/, processors/pruning.py).
"""

LAYER = "host passes"
UNIT = "s"
MOVES = "recon_s"
STAGES = ("track establishment", "pruning")


def read(trace):
    """Seconds a reconstruction spends in STAGES (StageTimer's host
    clock, each boundary synchronizing the card), or None where none of
    them ran."""
    return trace.stage_s(*STAGES)
