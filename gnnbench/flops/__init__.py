"""Model FLOPs a training step requires, one file an architecture, found by
the configuration's ``model.arch``.  Each counts ``2 x rows x in x out`` for
every linear layer's forward, as much again for its weight gradient, and
as much again for its input gradient in every layer but layer 0 (whose
input, the features, needs none).  Aggregation adds, activations, the loss
and the optimizer are left out: they are a few FLOPs a row beside the
matmuls.  The count depends only on the configuration, never on how the
program implements the step."""
