"""train_step_ms (ms, host clock): the window over the optimizer steps
completed in it; the window ends at a synchronize after the last
dispatch."""


def read(run):
    steps = run.counts.get("steps")
    if not steps:
        return None
    return run.window_s * 1e3 / steps
