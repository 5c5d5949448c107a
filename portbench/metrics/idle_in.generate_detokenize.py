"""idle_in.generate_detokenize (%, program span): the share of the
traced window in which the card was idle while the innermost program
span was ``lrcn.generate.detokenize``: ``generate_captions`` turning a
fetched group's tokens into caption lines (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.idle_share(run, ("lrcn.generate.detokenize",))
