"""moe.kernels.qmatmul_roofline: kernels.qmatmul_roofline in the MoE cell, whose end-to-end metrics
have names and bounds of their own."""

from perfbench.readers import same_as

read = same_as("kernels.qmatmul_roofline")
