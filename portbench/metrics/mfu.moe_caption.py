"""mfu.moe_caption (%, host clock): the model operations of the MoE text
decoder's captions returned in the window, over the window's seconds
and the card's bf16 peak.  Each caption counts its image's prefix
(projector and prefill positions) and, at each search step it needs
(its words and EOS; ``max_words + 1`` where it never ended), its
beam's hypotheses' decode steps (``work/moe_lm.py``).  Padding rows and
steps past a caption's end count nothing."""

from portbench.work import moe_lm


def read(run):
    counts = run.counts
    if "rows_by_step" not in counts or "experts" not in counts:
        return None
    beam = run.traffic["beam_width"]
    # every caption needs its first step: a pass's captions are its
    # first step's hypotheses over the beam
    ops = sum(moe_lm.caption_flops(run.config, rows[0] // beam, rows)
              for rows in counts["rows_by_step"])
    return 100.0 * ops / run.window_s / run.peaks["flops_s"]["bf16"]
