"""epoch_ms: the window's ms over the map epochs whose mapping finished
inside it (an epoch runs from OSDMap.apply_incremental to a usable
OSDMapMapping)."""


def read(run):
    lo, hi = run.window
    done = sum(1 for e in run.epochs if e["ok"] and e["t1"] <= hi)
    if not done:
        return None
    return (hi - lo) * 1e3 / done
