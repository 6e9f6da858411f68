"""Device time a thousand rows of the build stage `build.upload`: the rows'
upload to the card (models/db.py build_database). The summed durations
of the device operations that start between the stage's marks and the
next ones, over the complete marked builds of the traced window
(portbench/stages.py), over their thousands of rows, in microseconds.
Layer: the database build."""

from portbench import stages


def read(rec):
    return stages.per_krow(rec, "build.upload")
