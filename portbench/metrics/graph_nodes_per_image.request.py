"""``graph_nodes_per_image``: work nodes of the programs a slice image
replays (``program_trace.graph_nodes_per_image``)."""

from portbench.program_trace import graph_nodes_per_image as read  # noqa: F401
