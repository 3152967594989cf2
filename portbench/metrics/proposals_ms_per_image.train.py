"""``proposals_ms_per_image``: device ms a slice image of the replayed
programs' work under the layer scope ``proposals``, the two-stage query
init from the encoder's tokens (``program_trace.scope_ms_per_image``)."""

from portbench.program_trace import layer_reader

read = layer_reader("proposals")
