"""GAF records augmented per second: every job's records over the window's
whole time (the window ends with the job that crosses ``--seconds``)."""


def read(run):
    return run.work["records"] * run.jobs / run.window_s
