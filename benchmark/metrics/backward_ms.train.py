"""Device milliseconds a train step in the program's "backward" span:
`torch.autograd.grad` of the loss, the gathers' backward among it
(benchmark/program_spans.py)."""
from benchmark import program_spans


def read(run):
    return program_spans.stage_ms(run, "step", "backward", "device_ms")
