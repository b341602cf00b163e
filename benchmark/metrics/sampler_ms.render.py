"""Device milliseconds a render in the program's "sampler" spans, their own
time (a nested span of the same name counted once): self time of the
spans under the window's "render" roots (benchmark/program_spans.py)."""
from benchmark import program_spans


def read(run):
    return program_spans.stage_ms(run, "render", "sampler", "self_ms")
