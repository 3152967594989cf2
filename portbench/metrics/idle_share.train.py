"""``idle_share``, read where it moves the cell's end-to-end metric
(``readers.idle_share``)."""

from portbench.readers import idle_share as read  # noqa: F401
