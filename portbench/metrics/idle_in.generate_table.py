"""idle_in.generate_table (%, program span): the share of the traced
window in which the card was idle while the innermost program span was
``lrcn.generate.table``: ``decode/writer.py:generate_captions`` rebuilding
its resident feature table (``store.table()``, L1 normalization, cast,
upload) on the host (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.idle_share(run, ("lrcn.generate.table",))
