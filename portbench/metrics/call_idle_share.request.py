"""``call_idle_share``: % of the slice in which the card is idle while
the host is in one of the program's ``egtr.*`` spans
(``program_trace.call_idle_share``)."""

from portbench.program_trace import call_idle_share as read  # noqa: F401
