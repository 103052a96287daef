"""moe.tokens_per_s: tokens_per_s in the MoE cell, whose end-to-end metrics
have names and bounds of their own."""

from perfbench.readers import same_as

read = same_as("tokens_per_s")
