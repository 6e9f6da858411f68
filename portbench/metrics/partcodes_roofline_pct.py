"""Kernel P's share of its roofline: the least time of its work over the
traced builds' chunks over the summed durations of its launches, in
percent.  The least time is the larger of its fp32 operations (a multiply
and an add a dimension of each distance to each of the c1 * c2 level-2
centroids, 2 * rows * p * c1 * c2 * vl) at the H100's 67 TFLOP/s and its
bytes (the rows, the codebook and both norms read once, an int64 code a
(row, part) written) at 3.35 TB/s; the operations bind.  The kernel is
found by name; a program without it reads nothing.  Layer: the chunk
encoder (models/db.py encode_part_codes -> kernel P,
csrc/partcodes.cu)."""

KERNELS = ("part_codes_kernel",)
# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit): float32
# (non-tensor) operations/s and HBM bytes/s
PEAK_F32_OPS_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(rows: int, p: int, k: int, vl: int) -> float:
    """Least seconds of kernel P over one encode chunk of `rows` rows, p
    parts of vl dimensions and k centroids a part."""
    ops = 2 * rows * p * k * vl
    moved = rows * p * vl * 4 + p * k * (vl + 1) * 4 + rows * p * (4 + 8)
    return max(ops / PEAK_F32_OPS_PER_S, moved / PEAK_BYTES_PER_S)


def read(rec):
    t = rec.trace
    if rec.kind != "build" or t is None:
        return None
    launches = [e - s for name, s, e in t.kernels()
                if any(k in name for k in KERNELS)]
    if not launches or len(launches) != rec.builds * len(rec.chunk_rows):
        return None
    c = rec.pqt
    least = rec.builds * sum(
        bound_s(r, c["p"], c["c1"] * c["c2"], c["dim"] // c["p"])
        for r in rec.chunk_rows)
    return 100.0 * least / (sum(launches) / 1e6)
