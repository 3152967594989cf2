"""``warmup_s``: seconds of the eager warm-ups of the programs made in set-up
(``program_trace.setup_seconds``)."""

from portbench.program_trace import setup_seconds


def read(ctx):
    return setup_seconds("warmup_s")
