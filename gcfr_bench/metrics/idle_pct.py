"""idle_pct.<split> (relight, sweep, train): the share of the traced stretch in which no
operation ran on the device."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
