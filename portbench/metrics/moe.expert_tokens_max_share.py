"""moe.expert_tokens_max_share (%, program counter): the share of the
window's routed tokens that went to the busiest expert of their call (a
search step, or an image group's prefill) in their layer: the tokens of
each call's busiest expert, summed over calls and expert layers, over
the tokens routed, from the program's expert counter
(``models/moe_text.py``), read once after the window.  A mean of each
call's largest share, weighted by the call's tokens.  An even router
gives each of the E experts 1 / E of a call's routed tokens; one expert
takes at most 1 / k of them (each token once), as at a search's first
step, whose hypotheses all feed BOS after prefixes that differ only in
the image's position.  The fuller the busiest expert, the longer its
group in the grouped product."""


def read(run):
    experts = run.counts.get("experts")
    if not experts:
        return None
    routed = sum(map(sum, experts["tokens"]))
    if not routed:
        return None
    return 100.0 * sum(experts["busiest"]) / routed
