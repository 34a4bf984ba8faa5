"""Per-layer metric `layer_s.retri`: seconds a reconstruction spends in
stage 7 (controllers/retriangulation.py, ops/triangulation.py).
"""

LAYER = "retriangulation"
UNIT = "s"
MOVES = "recon_s"
STAGES = ("retriangulation",)


def read(trace):
    """Seconds a reconstruction spends in STAGES (StageTimer's host
    clock, each boundary synchronizing the card), or None where none of
    them ran."""
    return trace.stage_s(*STAGES)
