"""``conv_ms_per_image``, read where it moves the cell's end-to-end metric
(``readers.conv_ms_per_image``)."""

from portbench.readers import conv_ms_per_image as read  # noqa: F401
