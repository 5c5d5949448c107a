"""idle_in.graph_replay (%, program span): the share of the traced
window in which the card was idle while the innermost program span was
``lrcn.graph.replay``: ``utils/graphs.py`` copying a dispatch's inputs
into its graph, launching the graph and copying its outputs out
(``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.idle_share(run, ("lrcn.graph.replay",))
