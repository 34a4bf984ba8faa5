"""Per-layer metric `layer_s.frontend`: seconds a reconstruction spends in
stages 0-2 (processors/view_graph_manipulation.py,
estimators/view_graph_calibration.py, estimators/relpose.py,
processors/pair_inliers.py, processors/undistortion.py).
"""

LAYER = "front end"
UNIT = "s"
MOVES = "recon_s"
STAGES = ("preprocessing", "view graph calibration",
          "relative pose estimation")


def read(trace):
    """Seconds a reconstruction spends in STAGES (StageTimer's host
    clock, each boundary synchronizing the card), or None where none of
    them ran."""
    return trace.stage_s(*STAGES)
