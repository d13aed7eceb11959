"""batch_qps: queries of a closed loop whose top-k reached host memory
inside the window, over the window's length (from a wave's return to the
return of the first wave at ``--seconds`` or later)."""


def read(rec):
    if rec["cell"]["traffic"].get("loop") != "closed":
        return None
    win = rec["window"]
    return win.queries / (win.t1 - win.t0)
