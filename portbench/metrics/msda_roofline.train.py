"""``msda_roofline``, read where it moves the cell's end-to-end metric
(``readers.msda_roofline``)."""

from portbench.readers import msda_roofline as read  # noqa: F401
