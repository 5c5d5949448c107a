"""idle_in.extract_upload (%, program span): the share of the traced
window in which the card was idle while the innermost program span was
``lrcn.extract.upload``: ``data/images.py:extract_features`` handing a
group's pixels to the card (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.idle_share(run, ("lrcn.extract.upload",))
