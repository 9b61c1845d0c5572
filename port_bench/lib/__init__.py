"""The harness's general parts: the spec, the traffic generator, the
seeded inputs, the trace reduction and the result line."""
