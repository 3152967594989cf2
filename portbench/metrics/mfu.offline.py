"""``mfu``, read where it moves the cell's end-to-end metric
(``readers.mfu``)."""

from portbench.readers import mfu as read  # noqa: F401
