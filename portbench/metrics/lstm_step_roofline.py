"""lstm_step_roofline (%, device trace): the least time the card needs for
the LSTM steps of the window's captions, over the device time of the
kernels named below.  The steps are counted from the captions, whatever
runs them: for each pass and search step, one LSTM-1 and one LSTM-2 step
over the hypotheses still needed (``work/lstm_step.py``; operations bound
it at these shapes).  Padding rows and masked steps are work the kernel
does and the count leaves out."""

from portbench.work import bound_s, lstm_step

KERNELS = ("lstm_step_",)


def read(run):
    if run.timeline is None or "rows_by_step" not in run.counts:
        return None
    kernel_s = run.timeline.kernel_s(KERNELS)
    if kernel_s <= 0:
        return None
    cfg = run.config
    h1, h2 = cfg["hidden"]
    layers = ((cfg["embed"], h1), (2 * cfg["factor_dim"], h2))
    need = 0.0
    for rows_by_step in run.counts["rows_by_step"]:
        for rows in rows_by_step:
            for x_dim, h_dim in layers:
                if rows:
                    need += bound_s(*lstm_step.cost(rows, x_dim, h_dim),
                                    run.peaks)
    return 100.0 * need / kernel_s
