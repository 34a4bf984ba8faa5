"""Per-layer metric `layer_s.io`: seconds a reconstruction spends reading
its input and writing its model (cli.py, io/database.py, io/convert.py,
io/colmap_model.py).
"""

LAYER = "CLI and IO"
UNIT = "s"
MOVES = "recon_s"
STAGES = ("read database", "read model", "write model")


def read(trace):
    """Seconds a reconstruction spends in STAGES (StageTimer's host
    clock, each boundary synchronizing the card), or None where none of
    them ran."""
    return trace.stage_s(*STAGES)
