"""Share of the traced window in which no kernel, copy or fill runs on
the card, %."""

from h100_bench import tracing


def read(run):
    return None if run.trace is None else tracing.idle_pct(run.trace)
