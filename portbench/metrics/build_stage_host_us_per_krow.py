"""Host time a thousand rows of the port's span `pqt.build.stage`: the
build's fills of its pinned slots with the host rows (models/db.py
`_row_chunks`, under `build_database`). The summed durations of the spans
that start inside the traced window, over the thousands of rows of the
window's builds, in microseconds. The waits for a slot (`pqt.build.wait`)
are left out: they are not the host's own work. A program without the
span gives nothing. Layer: the database build."""


def read(rec):
    t = rec.trace
    if rec.kind != "build" or t is None or not rec.rows:
        return None
    lo, hi = t.window
    us = sum(e - s for name, s, e in t.host_ops
             if name == "pqt.build.stage" and lo <= s < hi)
    return us / (rec.rows / 1e3) if us > 0 else None
