"""The chunk encoder's kernel time per thousand rows: the summed durations
of the kernels each traced build runs from its start to its CSR assembly
(the benchmark marks both points on the device's timeline), over the
thousands of rows built, in microseconds.  Layer: the chunk encoder
(models/db.py chunk_encoder: distance tables, part codes, line codes,
packing, pair marks)."""


def read(rec):
    t = rec.trace
    if rec.kind != "build" or t is None or not rec.rows:
        return None
    marks = t.marks()
    if len(marks) != 2 * rec.builds:
        return None
    spans = [(marks[i][2], marks[i + 1][1])
             for i in range(0, len(marks), 2)]
    total = 0.0
    for name, s, e in t.kernels():
        if any(lo <= s and e <= hi for lo, hi in spans):
            total += e - s
    return total / (rec.rows / 1e3) if total > 0 else None
