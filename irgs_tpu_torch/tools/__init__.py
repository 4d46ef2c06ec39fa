"""The port's tools (≙ the repository's tools/ and root scripts): the analytic
dataset, the end-to-end and grid drivers, the benches, the tracer-bias
drives and the reproducer replay."""
