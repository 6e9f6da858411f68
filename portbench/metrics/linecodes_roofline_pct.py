"""Kernel L's share of its roofline: the least time of its work over the
traced builds' chunks (chip_smoke.py's byte and operation counts, in
yardstick.line_codes_bound_s) over the summed durations of its launches,
in percent.  Layer: the line codes (ops/linecodes.py -> kernel L,
csrc/linecodes.cu)."""

from portbench import yardstick

KERNELS = ("line_codes_fixed_kernel", "line_codes_any_kernel")


def read(rec):
    t = rec.trace
    if rec.kind != "build" or t is None:
        return None
    launches = [e - s for name, s, e in t.kernels()
                if any(k in name for k in KERNELS)]
    if len(launches) != rec.builds * len(rec.chunk_rows):
        return None
    least = rec.builds * sum(
        yardstick.line_codes_bound_s(r, rec.pqt["line_parts"], rec.pqt["c1"])
        for r in rec.chunk_rows)
    return 100.0 * least / (sum(launches) / 1e6)
