"""captions_per_s (captions/s, host clock): caption lines returned in the
window over the window's seconds.  Padding rows are no captions."""


def read(run):
    captions = run.counts.get("captions")
    if not captions:
        return None
    return captions / run.window_s
