"""topk_lse_roofline (%, device trace): the least time the card needs for
the top-k and log-sum-exp of the window's captions, over the device time
of the kernels named below.  Counted from the captions: for each pass and
search step, one (rows, V) float32 read with k = the beam, over the
hypotheses still needed (``work/topk_lse.py``; bytes bound it)."""

from portbench.work import bound_s, topk_lse

KERNELS = ("topk_lse_",)


def read(run):
    if run.timeline is None or "rows_by_step" not in run.counts:
        return None
    kernel_s = run.timeline.kernel_s(KERNELS)
    if kernel_s <= 0:
        return None
    v, k = run.config["vocab_size"], run.traffic["beam_width"]
    need = sum(bound_s(*topk_lse.cost(rows, v, k), run.peaks)
               for rows_by_step in run.counts["rows_by_step"]
               for rows in rows_by_step if rows)
    return 100.0 * need / kernel_s
