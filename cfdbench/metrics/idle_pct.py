"""idle_pct (device): 1 − the union of the device's activities ÷ the traced
stretch's wall time, in %; the idlest chip's."""


def read(ranks, problem):
    if not any(r["busy_us"] for r in ranks):
        return None
    return max(100.0 * (1.0 - r["busy_us"] / r["stretch_us"]) for r in ranks)
