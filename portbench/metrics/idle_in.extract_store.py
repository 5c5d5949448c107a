"""idle_in.extract_store (%, program span): the share of the traced
window in which the card was idle while the innermost program span was
``lrcn.extract.store``: ``extract_features`` L1-normalizing a group's
fc7 rows and adding them to the feature store (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.idle_share(run, ("lrcn.extract.store",))
