"""idle_in.train_data (%, program span): the share of the traced window
in which the card was idle while the innermost program span was
``lrcn.train.batch`` or ``lrcn.train.wait_data``: the training host
loops making a dispatch's batch (the decoder's ``_stacked``, the joint's
``put_local``) or waiting for the joint's prefetched images
(``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.idle_share(run, ("lrcn.train.batch", "lrcn.train.wait_data"))
