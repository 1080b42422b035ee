"""The harness: traffic, the system under test, tracing, the check."""
