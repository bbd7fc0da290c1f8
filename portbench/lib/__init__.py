"""The harness: inputs, registry, job loop, trace reading, judge."""
