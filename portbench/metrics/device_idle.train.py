"""device_idle.train (%, device trace): the share of the traced window in
which no kernel, copy or set ran on the card, in the training cells: what
the training host loops (``train/trainer.py:Trainer.train_epoch``,
``train/joint.py:JointTrainer.train_epoch``) leave idle."""


def read(run):
    if run.timeline is None or "steps" not in run.counts:
        return None
    t = run.timeline
    return 100.0 * (1.0 - t.busy_s / t.window_s)
