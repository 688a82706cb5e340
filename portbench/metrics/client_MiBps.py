"""client_MiBps: payload MiB of the client ops acknowledged inside the
window, over the window's seconds."""


def read(run):
    if not run.ops:
        return None
    lo, hi = run.window
    acked = sum(o["bytes"] for o in run.ops if o["ok"] and o["t1"] <= hi)
    return acked / 2**20 / (hi - lo)
