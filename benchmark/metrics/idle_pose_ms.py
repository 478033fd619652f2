"""idle_pose_ms: the median over the traced requests of the time inside
the program's ``pose`` span in which no operation ran on the card (the
span intersected with the trace's device events), in ms."""

from benchmark.metrics._program import idle_in_ms


def read(ctx):
    return idle_in_ms(ctx, "pose")
