"""Per-layer metric `layer_s.gp_host`: seconds a reconstruction spends in
stage 5 (estimators/global_positioning.py, the controller's filters,
normalization and rescue) outside its LM loops, the "gp/lm" spans: the
undistortion, the host prep and upload, the CSR plans, the download and
the passes after the solve.
"""

from sfm_bench import spans

LAYER = "GP"
UNIT = "s"
MOVES = "recon_s"


def read(trace):
    """Self time of the "global positioning" stage spans outside their
    "gp/lm" spans, a reconstruction, or None where the program records
    no spans or the stage did not run."""
    return spans.self_s(trace, "global positioning", "gp/lm")
