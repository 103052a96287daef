"""queries.model.torch_ops_share: model.torch_ops_share in the query cell, whose end-to-end metrics
have names and bounds of their own."""

from perfbench.readers import same_as

read = same_as("model.torch_ops_share")
