"""``matcher_ms``, read in the training cells (``readers.matcher_ms``)."""

from portbench.readers import matcher_ms as read  # noqa: F401
