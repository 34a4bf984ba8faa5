"""Per-layer metric `db_mb_per_s.io`: the COLMAP database reader's rate
(io/database.py read_database): the file's bytes that the "read
database/files" spans count (`bytes`) over those spans' seconds, in
MB/s (10^6 bytes).
"""

from sfm_bench import spans

LAYER = "CLI and IO"
UNIT = "MB/s"
MOVES = "recon_s"


def read(trace):
    """MB a second of the "read database/files" spans, or None where the
    program records no spans, no such span ran, or it counted no bytes."""
    records = spans.window(trace)
    files = [r for r in records or () if r.name == "read database/files"]
    nbytes = sum(r.counts.get("bytes", 0) for r in files)
    seconds = sum(spans.seconds(r) for r in files)
    if not nbytes or seconds <= 0:
        return None
    return nbytes / seconds / 1e6
