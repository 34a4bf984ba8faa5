"""Per-layer metric `layer_s.ba_host`: seconds a reconstruction spends in
stage 6 outside its LM loops, the "ba/lm" spans: building the inputs on
the host and their locality order, the upload, the CSR plans, the
download and write-back, and the controller's normalization, ray refresh
and filters (estimators/bundle_adjustment.py,
controllers/global_mapper.py).
"""

from sfm_bench import spans

LAYER = "BA"
UNIT = "s"
MOVES = "recon_s"


def read(trace):
    """Self time of the "bundle adjustment" stage spans outside their
    "ba/lm" spans, a reconstruction, or None where the program records
    no spans or the stage did not run."""
    return spans.self_s(trace, "bundle adjustment", "ba/lm")
