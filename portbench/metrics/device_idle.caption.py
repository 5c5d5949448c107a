"""device_idle.caption (%, device trace): the share of the traced window
in which no kernel, copy or set ran on the card, in the caption cells:
what the bulk decode's host loop (``decode/writer.py:generate_captions``)
and, over images, the encoder's group loop
(``data/images.py:extract_features``) leave idle."""


def read(run):
    if run.timeline is None or "captions" not in run.counts:
        return None
    t = run.timeline
    return 100.0 * (1.0 - t.busy_s / t.window_s)
