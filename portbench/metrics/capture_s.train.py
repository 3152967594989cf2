"""``capture_s``: seconds of the captures of the programs made in set-up
(``program_trace.setup_seconds``)."""

from portbench.program_trace import setup_seconds


def read(ctx):
    return setup_seconds("capture_s")
