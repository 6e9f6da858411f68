"""Device time a thousand rows of the build stage `encode.payload`: each
chunk's line codes (kernel L), packing and pair marks, summed over the
chunk encoder's replays. The summed durations of the device operations
that start between the stage's marks and the next ones, over the
complete marked builds of the traced window (portbench/stages.py), over
their thousands of rows, in microseconds. Layer: the chunk encoder."""

from portbench import stages


def read(rec):
    return stages.per_krow(rec, "encode.payload")
