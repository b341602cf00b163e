"""Device milliseconds a train step in the program's "forward" span: the
step's render and loss, with the stages inside them
(benchmark/program_spans.py)."""
from benchmark import program_spans


def read(run):
    return program_spans.stage_ms(run, "step", "forward", "device_ms")
