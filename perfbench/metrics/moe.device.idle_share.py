"""moe.device.idle_share: device.idle_share in the MoE cell, whose end-to-end metrics
have names and bounds of their own."""

from perfbench.readers import same_as

read = same_as("device.idle_share")
