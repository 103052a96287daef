"""queries.request_p95_ms: request_p95_ms in the query cell, whose end-to-end metrics
have names and bounds of their own."""

from perfbench.readers import same_as

read = same_as("request_p95_ms")
