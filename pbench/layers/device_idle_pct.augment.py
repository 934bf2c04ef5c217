"""The card's idle share of the augment window: 100 less the union of its
kernels, copies and fills over the window, from the profiler's trace."""


def read(run):
    d = run.device
    if not d or not d["ops"]:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
