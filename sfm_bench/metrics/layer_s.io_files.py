"""Per-layer metric `layer_s.io_files`: seconds a reconstruction spends in
the binary formats' readers and writers (io/colmap_model.py,
io/database.py), apart from the conversions to and from the scene
(io/convert.py): the spans named "*/files" ("read model/files", "read
database/files", "write model/files").
"""

from sfm_bench import spans

LAYER = "CLI and IO"
UNIT = "s"
MOVES = "recon_s"


def read(trace):
    """Seconds a reconstruction spends in "*/files" spans (the program's
    host clock, no synchronize), or None where the program records no
    spans or none of them ran."""
    records = spans.window(trace)
    files = [r for r in records or () if r.name.endswith("/files")]
    if not files:
        return None
    return sum(spans.seconds(r) for r in files) / trace.recons
